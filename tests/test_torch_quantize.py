"""The port's uniform quantizers and PTQ baselines against the reference's
`core/quantize.py` on the same numpy inputs.

Tolerances: the activation quantizers (Eq. 10) exact (codes and
dequantized values; round half to even on both sides); RTN exact; GPTQ
within 1e-6 (float64 numpy on both sides); Fig. 2's two MSEs rtol 1e-6."""
import numpy as np
import pytest
import torch

from repro.core import quantize as ref
from repro_torch.core import quantize as port

from _xfw import assert_close, assert_equal, both

pytestmark = pytest.mark.tier1


@pytest.mark.parametrize("bits", [4, 8])
def test_activation_quantizers_equal_the_reference(bits):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(6, 40)) * 3).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 0.0]             # ties and a zero
    amax = np.abs(x).max(axis=1, keepdims=True).astype(np.float32)
    want, got = both(lambda a: ref.sym_scale(a, bits), lambda a: port.sym_scale(a, bits), amax)
    assert_equal(got, want, "sym_scale")
    scale = np.array(want)
    want, got = both(lambda a, s: ref.quantize_sym(a, s, bits),
                     lambda a, s: port.quantize_sym(a, s, bits), x, scale)
    assert got.dtype == np.int8
    assert_equal(got, want, "quantize_sym")
    want, got = both(ref.dequantize_sym, port.dequantize_sym, np.array(want), scale)
    assert_equal(got, want, "dequantize_sym")
    for axis in (None, 0, 1):
        want, got = both(lambda a: ref.fake_quant_sym(a, bits, axis=axis),
                         lambda a: port.fake_quant_sym(a, bits, axis=axis), x)
        assert_equal(got, want, f"fake_quant_sym axis={axis}")
    one = port.quantize_sym(torch.tensor([0.5, 1.5, 2.5, -0.5]), torch.tensor(1.0), bits)
    assert one.tolist() == [0, 2, 2, 0]


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_rtn_is_exact(bits, per_channel):
    w = np.random.default_rng(bits).normal(size=(48, 24)).astype(np.float32)
    want = ref.rtn_weight(w, bits, per_channel=per_channel)
    got = port.rtn_weight(w, bits, per_channel=per_channel)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def _hessian(rng, d_in, n=256):
    x = rng.normal(size=(n, d_in))
    x[:, 3] = 0.0                                  # a dead input channel
    return 2 * x.T @ x / n


@pytest.mark.parametrize("centroids", [False, True], ids=["grid", "codebook"])
@pytest.mark.parametrize("blocksize", [128, 16])
def test_gptq_equals_the_reference(blocksize, centroids):
    rng = np.random.default_rng(blocksize)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    h = _hessian(rng, 64)
    cents = np.sort(rng.normal(size=8)) if centroids else None
    want = ref.gptq(w, h, 3, blocksize=blocksize, centroids=cents)
    got = port.gptq(w, h, 3, blocksize=blocksize, centroids=cents)
    assert isinstance(got, port.GPTQResult)
    assert_close(got.w_q, want.w_q, atol=1e-6, what="GPTQ weights")
    assert got.err_frob == pytest.approx(want.err_frob, rel=1e-6, abs=1e-6)
    assert got.err_hessian == pytest.approx(want.err_hessian, rel=1e-6, abs=1e-6)
    assert_close(port.gptq_quantize(w, h, 3, blocksize=blocksize, centroids=cents),
                 np.asarray(ref.gptq_quantize(w, h, 3, blocksize=blocksize, centroids=cents)),
                 atol=1e-6, what="gptq_quantize")
    # GPTQ's objective is below RTN's on the same Hessian
    if not centroids:
        rtn = ref.rtn_weight(w, 3).astype(np.float64) - w
        assert got.err_hessian < float(np.einsum("io,ij,jo->", rtn, h, rtn) / w.shape[1])


def test_clustering_vs_quant_mse_equals_the_reference():
    w = np.random.default_rng(5).standard_t(4, size=(64, 64)).astype(np.float32)
    for bits in (2, 3, 4):
        want = ref.clustering_vs_quant_mse(w, bits)
        got = port.clustering_vs_quant_mse(w, bits)
        assert got == pytest.approx(want, rel=1e-6)
        assert got[0] < got[1]          # Fig. 2: clustering beats the uniform grid
