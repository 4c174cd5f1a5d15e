"""The port's fused LUT GEMM/GEMV (plain versions, on the CPU) against the
reference: `repro.kernels.ref.lut_matmul_fused_ref` and the Pallas kernels in
interpret mode through `repro.kernels.ops.lut_gemm_fused(interpret=True)`.

Tolerance: f32 sums of K terms taken in another order — rtol 1e-5 plus
atol 1e-5 * ||T(x) row|| * max ||w column||. The quantized activation
integers themselves must be exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core.lut import pack_codes
from repro.kernels import lut_matmul as ref_lm
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core import api as port_api
from repro_torch.kernels import lut_matmul as port_lm
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref

from _xfw import assert_close, assert_equal, np_of

pytestmark = pytest.mark.tier1

K_RAW, N = 45, 24     # K needs group padding at every width (46 / 48 / 48)


def _operands(m, nbits, seed, k=K_RAW, n=N):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << nbits, (k, n)).astype(np.uint8)
    cb = np.sort(rng.normal(size=1 << nbits) * 0.05).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    smooth = rng.uniform(0.5, 1.5, k).astype(np.float32)
    return x, smooth, codes, cb, pack_codes(codes, nbits)


def _atol(x, inv, codes, cb, quantize):
    xt = x * inv
    if quantize:
        xt = np.clip(np.round(xt), -127, 127)
    w = cb[codes]
    return 1e-5 * np.linalg.norm(xt, axis=1, keepdims=True) * np.linalg.norm(w, axis=0).max()


@pytest.mark.parametrize("quantize", [True, False], ids=["quant", "float"])
@pytest.mark.parametrize("nbits", [2, 3, 4])
@pytest.mark.parametrize("m", [1, 8, 130])
def test_lut_gemm_fused_vs_reference_oracle_and_pallas(m, nbits, quantize):
    x, smooth, codes, cb, packed = _operands(m, nbits, 100 * m + 10 * nbits + quantize)
    s_q = np.float32(0.03)
    inv = (1.0 / (smooth * s_q) if quantize else 1.0 / smooth).astype(np.float32)
    act = s_q if quantize else np.float32(1.0)

    got = np_of(port_ops.lut_gemm_fused(
        torch.from_numpy(x), torch.from_numpy(inv), torch.from_numpy(packed),
        torch.from_numpy(cb), float(act), quantize=quantize, nbits=nbits))
    assert got.shape == (m, N) and got.dtype == np.float32

    kp = packed.shape[0] * 8 // nbits
    xp = np.pad(x, ((0, 0), (0, kp - K_RAW)))
    invp = np.pad(inv, (0, kp - K_RAW))
    oracle = np.asarray(ref_ref.lut_matmul_fused_ref(
        jnp.asarray(xp), jnp.asarray(invp), jnp.asarray(packed),
        jnp.asarray(ref_ops.pad_codebook(jnp.asarray(cb))), act,
        quantize=quantize, nbits=nbits))
    pallas = np.asarray(ref_ops.lut_gemm_fused(
        jnp.asarray(x), jnp.asarray(inv), jnp.asarray(packed), jnp.asarray(cb),
        jnp.asarray(act), quantize=quantize, interpret=True, nbits=nbits))
    atol = _atol(x, inv, codes, cb, quantize) * float(act)
    assert_close(got, oracle, rtol=1e-5, atol=atol, what="port vs lut_matmul_fused_ref")
    assert_close(got, pallas, rtol=1e-5, atol=atol, what="port vs Pallas interpret")


@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_kernel_level_wrappers_vs_reference_oracle(nbits):
    """lut_matmul_fused / lut_matmul_fused_gemv take the group-padded K and the
    KC-padded codebook and leave the s_q rescale to the caller."""
    x, smooth, codes, cb, packed = _operands(6, nbits, 5 + nbits, k=48, n=20)
    inv = (1.0 / (smooth * 0.05)).astype(np.float32)
    cb16 = np.pad(cb, (0, 16 - cb.size))
    args = [torch.from_numpy(a) for a in (x, inv, packed, cb16)]
    want = np.asarray(ref_ref.lut_matmul_fused_ref(
        jnp.asarray(x), jnp.asarray(inv), jnp.asarray(packed), jnp.asarray(cb16),
        1.0, quantize=True, nbits=nbits))
    atol = _atol(x, inv, codes, cb, True)
    for fn in (port_lm.lut_matmul_fused, port_lm.lut_matmul_fused_gemv):
        got = np_of(fn(*args, quantize=True, nbits=nbits))
        assert_close(got, want, rtol=1e-5, atol=atol, what=fn.__name__)


def test_quantized_integers_are_exact_incl_ties_and_clip():
    """q = clip(round(x * inv), +-127): round-half-to-even, symmetric clip."""
    rng = np.random.default_rng(3)
    ties = np.arange(-130, 131, dtype=np.float32) + 0.5
    x = np.concatenate([ties, rng.normal(size=251).astype(np.float32) * 60]).reshape(2, -1)
    inv = np.ones(x.shape[1], np.float32)
    inv[::3] = 0.37
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * inv), -127, 127).astype(jnp.int8))
    got = torch.clamp(torch.round(torch.from_numpy(x) * torch.from_numpy(inv)),
                      -127, 127).to(torch.int8)
    assert_equal(np_of(got), want, "Eq. 11 integers")
    assert want.min() == -127 and want.max() == 127
    # and through the plain version: identity codebook rows recover q exactly
    k = x.shape[1]
    k4 = k + (-k % 2)
    codes = np.zeros((k4, 1), np.uint8)
    cb = np.zeros(16, np.float32)
    cb[0] = 1.0
    y = port_ref.lut_matmul_fused_ref(
        torch.from_numpy(np.pad(x, ((0, 0), (0, k4 - k)))),
        torch.from_numpy(np.pad(inv, (0, k4 - k))),
        torch.from_numpy(pack_codes(codes, 4)), torch.from_numpy(cb), 1.0,
        quantize=True, nbits=4)
    assert_equal(np_of(y)[:, 0], want.astype(np.float32).sum(axis=1), "sum of q")


@pytest.mark.parametrize("act_scale", [None, 0.04], ids=["float", "quant"])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_clustered_linear_vs_reference(nbits, act_scale):
    rng = np.random.default_rng(11 * nbits)
    d_in, d_out = 37, 29
    codes = rng.integers(0, 1 << nbits, (d_in, d_out)).astype(np.uint8)
    cb = np.sort(rng.normal(size=1 << nbits) * 0.1).astype(np.float32)
    smooth = rng.uniform(0.5, 2.0, d_in).astype(np.float32)
    w = cb[codes] / smooth[:, None]
    x = rng.normal(size=(2, 5, d_in)).astype(np.float32)
    ref_ct = ref_api.dense_to_clustered(w, codes, cb, smooth, act_scale, nbits)
    port_ct = port_api.dense_to_clustered(w, codes, cb, smooth, act_scale, nbits, device="cpu")
    for f in ("codes", "codebook", "smooth", "packed", "inv_scale"):
        assert_equal(np_of(getattr(port_ct, f)), np.asarray(getattr(ref_ct, f)), f)
    with ref_ops.lut_serving("interpret"):
        want = np.asarray(ref_ops.clustered_linear(jnp.asarray(x), ref_ct))
    got = np_of(port_ops.clustered_linear(torch.from_numpy(x), port_ct))
    assert got.shape == (2, 5, d_out)
    x2 = x.reshape(-1, d_in)
    inv = np.asarray(ref_ct.inv_scale)
    atol = (_atol(x2, inv, codes, cb, act_scale is not None)
            * (act_scale or 1.0)).reshape(2, 5, 1)
    assert_close(got, want, rtol=1e-5, atol=atol, what="clustered_linear")
    # dequant / gather contraction agree with the reference's too
    assert_close(np_of(port_api.clustered_dequant(port_ct)),
                 np.asarray(ref_api.clustered_dequant(ref_ct)), rtol=1e-6, atol=1e-7,
                 what="clustered_dequant")
    assert_close(np_of(port_api.clustered_matmul(torch.from_numpy(x), port_ct)),
                 np.asarray(ref_api.clustered_matmul(jnp.asarray(x), ref_ct)),
                 rtol=1e-5, atol=atol, what="clustered_matmul")


def test_transform_params_and_packed_view_follow_reference():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, (8, 4)).astype(np.uint8)
    cb = np.linspace(-1, 1, 16).astype(np.float32)
    smooth = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    for act in (None, 0.02):
        r = ref_api.dense_to_clustered(cb[codes], codes, cb, smooth, act, 4)
        p = port_api.dense_to_clustered(cb[codes], codes, cb, smooth, act, 4, device="cpu")
        for drop_inv in (False, True):
            if drop_inv:
                r, p = r._replace(inv_scale=None), p._replace(inv_scale=None)
            ri, ra, rq = ref_ops._transform_params(r)
            pi, pa, pq = port_ops._transform_params(p)
            assert rq == pq == (act is not None)
            assert_close(np_of(pi), np.asarray(ri), rtol=1e-6, what="inv_scale")
            assert float(pa) == pytest.approx(float(ra))
        assert_equal(np_of(port_ops.packed_view(p)), np.asarray(ref_ops.packed_view(r)),
                     "packed_view")
    stored_packed = p._replace(packed=None, codes=p.packed)
    assert port_ops.packed_view(stored_packed) is stored_packed.codes
    with pytest.raises(ValueError, match="no `packed` field"):
        port_ops.packed_view(p._replace(packed=None))


def test_pinned_value_errors_match_reference():
    for nbits, rows in ((4, 9), (3, 7), (7, 8)):
        with pytest.raises(ValueError) as r:
            ref_lm._check_packed_shape(16, (rows, 8), nbits, "lut_matmul_fused")
        with pytest.raises(ValueError) as p:
            port_lm._check_packed_shape(16, (rows, 8), nbits, "lut_matmul_fused")
        assert str(p.value) == str(r.value)
    x = torch.zeros(4, 16)
    inv = torch.ones(16)
    packed = torch.zeros(8, 8, dtype=torch.uint8)
    cb = torch.zeros(16)
    with pytest.raises(ValueError, match=r"packed codes have 8 rows but K=16 at 2-bit"):
        port_lm.lut_matmul_fused(x, inv, packed, cb, nbits=2)
    with pytest.raises(ValueError, match=r"codebook must be padded to \(16,\); got \(8,\)"):
        port_lm.lut_matmul_fused(x, inv, packed, torch.zeros(8))
    with pytest.raises(ValueError, match=r"inv_scale must be \(16,\); got \(15,\)"):
        port_lm.lut_matmul_fused_gemv(x, torch.ones(15), packed, cb)
    with pytest.raises(ValueError, match=r"M \(128\) must be < 128"):
        port_lm.lut_matmul_fused_gemv(torch.zeros(128, 16), inv, packed, cb)
    with pytest.raises(ValueError, match="must be contiguous"):
        port_lm.lut_matmul_fused(torch.zeros(16, 4).T, inv, packed, cb)
    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        port_lm.lut_matmul_fused(x.double(), inv, packed, cb)
    with pytest.raises(ValueError) as r:
        ref_ops.pad_codebook(jnp.zeros(17))
    with pytest.raises(ValueError) as p:
        port_ops.pad_codebook(torch.zeros(17))
    assert str(p.value) == str(r.value)
    with pytest.raises(ValueError) as r:
        ref_api.dense_to_clustered(np.zeros((4, 4)), np.zeros((4, 4), np.uint8),
                                   np.zeros(8), nbits=2)
    with pytest.raises(ValueError) as p:
        port_api.dense_to_clustered(np.zeros((4, 4)), np.zeros((4, 4), np.uint8),
                                    np.zeros(8), nbits=2, device="cpu")
    assert str(p.value) == str(r.value)


def test_clustered_linear_refuses_a_stacked_codebook():
    ct = port_api.ClusteredTensor(torch.zeros(2, 8, 4, dtype=torch.uint8), torch.zeros(2, 16),
                                  torch.ones(2, 16))
    with pytest.raises(NotImplementedError, match="stacked codebook"):
        port_ops.clustered_linear(torch.zeros(3, 16), ct)


def test_cpu_tensors_launch_no_kernel():
    port_ops.reset_launch_counts()
    x, smooth, codes, cb, packed = _operands(3, 4, 1)
    port_ops.lut_gemm_fused(torch.from_numpy(x), torch.from_numpy(1 / smooth),
                            torch.from_numpy(packed), torch.from_numpy(cb), 1.0,
                            quantize=False, nbits=4)
    port_ops.lut_gemm_fused_multi(torch.from_numpy(x), torch.from_numpy(1 / smooth)[None],
                                  torch.from_numpy(np.pad(cb, (0, 16 - cb.size)))[None], [1.0],
                                  torch.from_numpy(packed), quantize=(False,), nbits=(4,))
    assert port_ops.launch_counts() == {"lut_matmul_fused_gemv": 0, "lut_matmul_fused": 0,
                                        "lut_matmul_fused_multi_gemv": 0,
                                        "lut_matmul_fused_multi": 0,
                                        "paged_pool_attention": 0, "lut_matmul_f32": 0,
                                        "lut_matmul_int8": 0, "smooth_quant": 0,
                                        "paged_dequant_attention": 0, "flash_attention": 0}
