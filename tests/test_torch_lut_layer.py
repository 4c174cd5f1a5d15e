"""The paper's §4 LUT layer in the port (on the CPU) against the reference:
`LUTLayer` / `build_lut_layer` / `lut_forward` and the bucket-table oracle
`lut_matmul_ref` (core/lut.py); the kernels' wrappers `ops.lut_gemm`,
`ops.lut_gemm_int8` (plain versions here) against the reference's Pallas
kernels in interpret mode; `smooth_quant` (bits 8 and 4, -128 saturation)
against the reference's; and the `examples/serve_lut.py layer_demo` sequence
end to end.

Tolerances: int8 codes, packed bytes and layer fields exact; f32 LUT
products rtol 1e-5 plus atol 1e-5 * ||activation row|| * max ||w column||
(sums of K terms taken in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as RC
from repro.core import lut as ref_lut
from repro.core import smoothing as ref_sm
from repro.core.lut import pack_codes
from repro.kernels import lut_matmul as ref_lm
from repro.kernels import ops as ref_ops
from repro.kernels import smooth_quant as ref_sq
from repro_torch.core import clustering as PC
from repro_torch.core import lut as port_lut
from repro_torch.core import smoothing as port_sm
from repro_torch.kernels import lut_matmul as port_lm
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import smooth_quant as port_sq

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import assert_close, assert_equal, np_of

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

T = torch.from_numpy


def _codes(k, n, nbits, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << nbits, (k, n)).astype(np.uint8)
    cb = np.sort(rng.normal(size=1 << nbits) * 0.05).astype(np.float32)
    return codes, cb, pack_codes(codes, nbits)


def _atol(a, codes, cb):
    w = cb[codes]
    return 1e-5 * np.linalg.norm(a.astype(np.float32), axis=1, keepdims=True) * \
        np.linalg.norm(w, axis=0).max()


# ---------------------------------------------------------------------------
# kernel wrappers: the plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [2, 3, 4])
@pytest.mark.parametrize("m", [1, 8, 130])
def test_lut_gemm_float_activations(m, nbits):
    k, n = 45, 24                       # K needs packing-group padding at every width
    codes, cb, packed = _codes(k, n, nbits, 10 * m + nbits)
    x = np.random.default_rng(m).normal(size=(m, k)).astype(np.float32)
    want = np.asarray(ref_ops.lut_gemm(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(cb),
                                       interpret=True, nbits=nbits))
    got = np_of(port_ops.lut_gemm(T(x), T(packed), T(cb), nbits=nbits))
    assert got.shape == (m, n) and got.dtype == np.float32
    assert_close(got, want, rtol=1e-5, atol=_atol(x, codes, cb), what="lut_gemm")
    xb = torch.from_numpy(x).to(torch.bfloat16)         # bf16 activations widen exactly
    assert_close(np_of(port_ops.lut_gemm(xb, T(packed), T(cb), nbits=nbits)),
                 np_of(xb.float()) @ cb[codes], rtol=1e-5, atol=_atol(x, codes, cb),
                 what="lut_gemm bf16")


@pytest.mark.parametrize("nbits", [2, 3, 4])
@pytest.mark.parametrize("m", [1, 8, 130])
def test_lut_gemm_int8(m, nbits):
    k, n = 45, 24
    codes, cb, packed = _codes(k, n, nbits, 20 * m + nbits)
    q = np.random.default_rng(m + 1).integers(-128, 128, (m, k)).astype(np.int8)
    act = np.float32(0.037)
    want = np.asarray(ref_ops.lut_gemm_int8(jnp.asarray(q), jnp.asarray(packed),
                                            jnp.asarray(cb), jnp.float32(act),
                                            interpret=True, nbits=nbits))
    got = np_of(port_ops.lut_gemm_int8(T(q), T(packed), T(cb), torch.tensor(act),
                                       nbits=nbits))
    assert got.shape == (m, n) and got.dtype == np.float32
    assert_close(got, want, rtol=1e-5, atol=act * _atol(q, codes, cb), what="lut_gemm_int8")
    assert_close(np_of(port_ops.lut_gemm_int8(T(q), T(packed), T(cb), float(act),
                                              nbits=nbits)), got, rtol=0, what="float s_q")


def test_lut_kernel_wrappers_keep_the_reference_value_errors():
    codes, cb, packed = _codes(64, 16, 4, 0)
    x, q = np.zeros((4, 64), np.float32), np.zeros((4, 64), np.int8)
    cb16 = np.pad(cb, (0, 16 - cb.size))
    cases = [  # (reference call, port call)
        (lambda: ref_lm.lut_matmul_f32(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(cb16),
                                       interpret=True, nbits=2),
         lambda: port_lm.lut_matmul_f32(T(x), T(packed), T(cb16), nbits=2)),
        (lambda: ref_lm.lut_matmul_int8(jnp.asarray(q), jnp.asarray(packed),
                                        jnp.asarray(cb16[:8]), jnp.float32(1), interpret=True),
         lambda: port_lm.lut_matmul_int8(T(q), T(packed), T(cb16[:8]), 1.0)),
        (lambda: ref_lm.lut_matmul_int8(jnp.asarray(q), jnp.asarray(packed[:10]),
                                        jnp.asarray(cb16), jnp.float32(1), interpret=True),
         lambda: port_lm.lut_matmul_int8(T(q), T(packed[:10]), T(cb16), 1.0)),
    ]
    for ref_call, port_call in cases:
        with pytest.raises(ValueError) as ref_err:
            ref_call()
        with pytest.raises(ValueError) as port_err:
            port_call()
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(TypeError, match="int8"):
        port_lm.lut_matmul_int8(T(x), T(packed), T(cb16), 1.0)
    with pytest.raises(ValueError, match="KC=16"):
        port_ops.lut_gemm(T(x), T(packed), T(np.zeros(17, np.float32)))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smooth_quant_against_the_reference_kernel(bits, dtype):
    """Exact integers, including inputs that saturate at -2^(bits-1) (-128 at
    8 bits: this kernel, unlike the fused LUT kernels, keeps it) and exact
    .5 ties (round half to even). The reference's kernel needs block
    multiples; the port's masks ragged shapes (checked against its plain
    version at 37 channels)."""
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(16, 256)) * 60).astype(np.float32)
    x[0, :8] = [-1000, 1000, 0.5, 1.5, -0.5, -2.5, 126.5, -127.5]
    x = np.asarray(torch.from_numpy(x).to(getattr(torch, dtype)).float())
    inv = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    inv[:8] = 1.0
    want = np.asarray(ref_sq.smooth_quant(jnp.asarray(x, getattr(jnp, dtype)),
                                          jnp.asarray(inv), bits=bits, bm=8, bc=128,
                                          interpret=True))
    got = np_of(port_sq.smooth_quant(T(x).to(getattr(torch, dtype)), T(inv), bits=bits))
    assert got.dtype == np.int8
    assert_equal(got, want, "smooth_quant codes")
    assert got.min() == -(1 << (bits - 1)) and got.max() == (1 << (bits - 1)) - 1
    ragged = T(x[:5, :37].copy())
    assert_equal(np_of(port_sq.smooth_quant(ragged, T(inv[:37].copy()), bits=bits)),
                 want[:5, :37], "ragged shape")
    with pytest.raises(ValueError, match="inv_scale"):
        port_sq.smooth_quant(ragged, T(inv), bits=bits)
    with pytest.raises(ValueError, match="bits"):
        port_sq.smooth_quant(ragged, T(inv[:37].copy()), bits=9)


def test_smooth_quant_input_matches_the_reference():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 3, 40)) * 20).astype(np.float32)
    s = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    want = np.asarray(ref_sm.smooth_quant_input(jnp.asarray(x), jnp.asarray(s),
                                                jnp.float32(0.11)))
    got = np_of(port_sm.smooth_quant_input(T(x), T(s), torch.tensor(0.11)))
    assert_equal(got, want, "Eq. 11 codes")
    assert_equal(np_of(port_sm.smooth_quant_input(T(x), T(s), 0.11, bits=4)),
                 np.asarray(ref_sm.smooth_quant_input(jnp.asarray(x), jnp.asarray(s),
                                                      jnp.float32(0.11), bits=4)),
                 "4-bit codes")


def test_adaptive_smooth_and_fold_are_exact():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    x[:, 7] *= 30
    w = rng.normal(0, 0.04, (96, 48)).astype(np.float32)
    want, got = ref_sm.adaptive_smooth(x), port_sm.adaptive_smooth(x)
    assert (got.kind, got.mse, got.mse_identity, got.act_scale) == (
        want.kind, want.mse, want.mse_identity, want.act_scale)
    assert_equal(got.s, want.s, "smoothing vector")
    assert got.kind != "identity"
    folded = ref_sm.fold_into_weight(w, want.s)
    assert_equal(port_sm.fold_into_weight(w, got.s), folded, "fold (numpy)")
    assert_equal(np_of(port_sm.fold_into_weight(T(w), got.s)), folded, "fold (tensor)")


# ---------------------------------------------------------------------------
# the frozen layer and the bucket-table oracle
# ---------------------------------------------------------------------------

def _layer(seed=5, d_in=96, d_out=40, k=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(32, d_in)).astype(np.float32)
    x[:, 3] *= 25
    w = rng.normal(0, 0.04, (d_in, d_out)).astype(np.float32)
    s = ref_sm.adaptive_smooth(x).s
    ws = ref_sm.fold_into_weight(w, s)
    cents = RC.kmeans_1d(ws, k)
    codes = np.searchsorted((cents[1:] + cents[:-1]) / 2, ws).astype(np.uint8)
    return x, w, ws, codes, cents, s


def test_lut_layer_fields_table_and_packing():
    x, w, ws, codes, cents, s = _layer()
    want = ref_lut.build_lut_layer(ws, codes, cents, s, x)
    got = port_lut.build_lut_layer(ws, codes, cents, s, x)
    for f in ("codes", "codebook", "smooth"):
        assert_equal(getattr(got, f), getattr(want, f), f)
    assert (got.act_scale, got.n_centroids) == (want.act_scale, want.n_centroids)
    assert_equal(got.packed_codes, want.packed_codes, "packed codes")
    assert_equal(got.table(), want.table(), "bucket table")
    assert_equal(got.table(4), want.table(4), "4-bit table")
    assert_equal(port_lut.pack4(codes), ref_lut.pack4(codes), "pack4")
    assert_equal(np_of(port_lut.unpack4(T(ref_lut.pack4(codes)), codes.shape[0])),
                 codes.astype(np.int32), "unpack4")
    for nbits in (2, 3, 4):
        c = np.random.default_rng(nbits).integers(0, 1 << nbits, (37, 9)).astype(np.uint8)
        assert_equal(np_of(port_lut.pack_codes_torch(T(c), nbits)), pack_codes(c, nbits),
                     f"device packer {nbits}-bit")
    with pytest.raises(ValueError, match="fit in 2 bits"):
        port_lut.pack_codes_torch(T(np.full((4, 4), 4, np.uint8)), 2)


def test_bucket_oracle_saturates_minus_128():
    codes, cb, _ = _codes(40, 12, 4, 6)
    q = np.random.default_rng(7).integers(-127, 128, (6, 40)).astype(np.int8)
    q[0, :5] = -128
    want = np.asarray(ref_lut.lut_matmul_ref(jnp.asarray(q), jnp.asarray(codes.astype(np.int32)),
                                             jnp.asarray(cb), jnp.float32(0.02)))
    got = np_of(port_lut.lut_matmul_ref(T(q), T(codes.astype(np.int32)), T(cb),
                                        torch.tensor(0.02)))
    assert_close(got, want, rtol=1e-5, atol=0.02 * _atol(q, codes, cb), what="bucket oracle")
    # the dequant form differs exactly where q = -128 (one LSB per such entry)
    deq = np_of(port_lut.lut_matmul_dequant_ref(T(q), T(codes), T(cb), 0.02))
    diff = np.abs(deq - got) > 1e-6
    assert diff[0].any() and not diff[1:].any()


def test_lut_forward_matches_the_reference():
    x, w, ws, codes, cents, s = _layer(8)
    layer_r = ref_lut.build_lut_layer(ws, codes, cents, s, x)
    layer_p = port_lut.build_lut_layer(ws, codes, cents, s, x)
    xin = x.reshape(4, 8, -1)
    want = np.asarray(ref_lut.lut_forward(layer_r, jnp.asarray(xin)))
    got = np_of(port_lut.lut_forward(layer_p, T(xin)))
    assert got.shape == (4, 8, w.shape[1])
    q = np_of(port_sm.smooth_quant_input(T(x), T(s), layer_p.act_scale))
    assert_close(got.reshape(32, -1), want.reshape(32, -1), rtol=1e-5,
                 atol=layer_p.act_scale * _atol(q, codes, cents), what="lut_forward")


# ---------------------------------------------------------------------------
# examples/serve_lut.py layer_demo, both packages
# ---------------------------------------------------------------------------

def _demo(api, C, sm, lut, ops, xp, x, w):
    sres = sm.adaptive_smooth(x)
    ws = sm.fold_into_weight(w, sres.s)
    cents = C.kmeans_1d(ws, 12)
    st = C.make_state(cents) if api == "ref" else C.make_state(cents, device="cpu")
    codes = np.asarray(C.assign(xp(ws), st))
    act = np.where(np.asarray(st.active))[0]
    remap = np.zeros(C.K_MAX, np.int64)
    for j, a in enumerate(act):
        remap[a] = j
    codes = remap[codes].astype(np.uint8)
    layer = lut.build_lut_layer(ws, codes, C.active_centroids(st), sres.s, x)
    if api == "ref":
        q = sm.smooth_quant_input(jnp.asarray(x), jnp.asarray(layer.smooth),
                                  jnp.asarray(layer.act_scale))
        y = ops.lut_gemm_int8(q, jnp.asarray(lut.pack4(codes)), jnp.asarray(layer.codebook),
                              jnp.float32(layer.act_scale))
    else:
        q = sm.smooth_quant_input(T(x), T(layer.smooth), layer.act_scale)
        y = ops.lut_gemm_int8(q, T(lut.pack4(codes)), T(layer.codebook), layer.act_scale)
    return codes, np_of(q) if api != "ref" else np.asarray(q), np.asarray(np_of(y)), layer


def test_layer_demo_end_to_end():
    rng = np.random.default_rng(0)
    d_in, d_out, n_tok = 512, 256, 64
    x = rng.normal(0, 1, (n_tok, d_in)).astype(np.float32)
    x[:, 7] *= 30          # activation outlier channel
    w = rng.normal(0, 0.04, (d_in, d_out)).astype(np.float32)
    rc, rq, ry, rl = _demo("ref", RC, ref_sm, ref_lut, ref_ops, jnp.asarray, x, w)
    pc, pq, py, pl = _demo("port", PC, port_sm, port_lut, port_ops, T, x, w)
    assert_equal(pc, rc, "codes")
    assert_equal(pq, rq, "Eq. 11 codes")
    assert_equal(pl.codebook, rl.codebook, "codebook")
    assert_close(py, ry, rtol=1e-5, atol=pl.act_scale * _atol(pq, pc, pl.codebook),
                 what="layer output")
    y_fp = x @ w
    rel = float(np.linalg.norm(py - y_fp) / np.linalg.norm(y_fp))
    assert rel < 0.3


def test_layer_demo_at_llama_width_matches_the_reference():
    """The same sequence at llama2-7b's d_in (4096) with 256 calibration
    tokens: port and reference agree, and both leave more than the demo's
    0.3 relative error — its bound holds at its own 512 x 256 only (one
    outlier channel folded into one weight row that 12 shared centroids
    cannot follow), which is why the on-card lut_layer phase reports it
    rather than holds the port to it."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (256, 4096)).astype(np.float32)
    x[:, 7] *= 30
    w = rng.normal(0, 0.04, (4096, 256)).astype(np.float32)
    rc, rq, ry, _ = _demo("ref", RC, ref_sm, ref_lut, ref_ops, jnp.asarray, x, w)
    pc, pq, py, pl = _demo("port", PC, port_sm, port_lut, port_ops, T, x, w)
    assert_equal(pc, rc, "codes")
    assert_equal(pq, rq, "Eq. 11 codes")
    assert_close(py, ry, rtol=1e-5, atol=pl.act_scale * _atol(pq, pc, pl.codebook),
                 what="layer output")
    y_fp = x @ w
    rels = [float(np.linalg.norm(y - y_fp) / np.linalg.norm(y_fp)) for y in (py, ry)]
    assert 0.3 < rels[0] < 0.5 and abs(rels[0] - rels[1]) < 1e-4
