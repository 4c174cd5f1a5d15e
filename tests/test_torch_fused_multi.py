"""The port's multi-projection LUT path (QKV, gate+up in one launch) against
the reference, and its bit-equality with the per-projection path inside the
port.

On the CPU the kernels' plain versions run. The reference runs its Pallas
kernels in interpret mode (`lut_gemm_fused_multi(interpret=True)`,
`lut_serving("interpret")`). Tolerances: rtol 1e-5 plus atol 1e-5 *
||T(x) row|| * max ||w column|| * s_q for one contraction (f32 sums of K terms
in another order); logits 2e-4 for whole steps. Fused-vs-per-projection
inside the port is `torch.equal`: no tolerance."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lut import pack_codes
from repro.kernels import lut_matmul as ref_lm
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.launch import engine as ref_engine
from repro.models import transformer as ref_tf
from repro_torch.convert import from_reference
from repro_torch.core import api as port_api
from repro_torch.kernels import lut_matmul as port_lm
from repro_torch.kernels import ops as port_ops
from repro_torch.launch import engine as port_engine
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_tf

from _xfw import (assert_close, cluster_params, np_of, port_model,
                  reference_model, to_numpy_tree)

pytestmark = pytest.mark.tier1

K = 128
WIDTHS = (128, 64, 64)        # the reference's per-projection tile widths agree here


def _group(rng, k, widths, nbits, quantize):
    """Per-projection numpy operands: codes, codebook, smooth, packed, inv, s_q."""
    out = []
    for n, nb, qz in zip(widths, nbits, quantize):
        codes = rng.integers(0, 1 << nb, (k, n)).astype(np.uint8)
        cb = np.sort(rng.normal(size=1 << nb) * 0.05).astype(np.float32)
        smooth = rng.uniform(0.5, 1.5, k).astype(np.float32)
        s_q = np.float32(0.03) if qz else np.float32(1.0)
        inv = (1.0 / (smooth * s_q)).astype(np.float32)
        out.append(dict(codes=codes, cb=cb, smooth=smooth, packed=pack_codes(codes, nb),
                        inv=inv, act=s_q))
    return out


def _atol(x, g, qz):
    xt = x * g["inv"]
    if qz:
        xt = np.clip(np.round(xt), -127, 127)
    w = g["cb"][g["codes"]]
    return (1e-5 * np.linalg.norm(xt, axis=1, keepdims=True)
            * np.linalg.norm(w, axis=0).max() * float(g["act"]))


CASES = ([(m, nb, (True, False, True)) for m in (1, 8, 130)
          for nb in ((2, 2, 2), (3, 3, 3), (4, 4, 4), (4, 2, 2))]
         + [(m, (4, 4, 4), qz) for m in (1, 8, 130)
            for qz in ((True,) * 3, (False,) * 3)])


@pytest.mark.parametrize("m,nbits,quantize", CASES,
                         ids=[f"m{m}-b{''.join(map(str, nb))}-q{''.join('TF'[not q] for q in qz)}"
                              for m, nb, qz in CASES])
def test_lut_gemm_fused_multi_vs_reference(m, nbits, quantize):
    rng = np.random.default_rng(1000 * m + 100 * nbits[0] + 10 * nbits[1] + sum(quantize))
    gs = _group(rng, K, WIDTHS, nbits, quantize)
    x = rng.normal(size=(m, K)).astype(np.float32)
    inv = np.stack([g["inv"] for g in gs])
    cb16 = np.stack([np.pad(g["cb"], (0, 16 - g["cb"].size)) for g in gs])
    acts = np.array([g["act"] for g in gs], np.float32)
    got = port_ops.lut_gemm_fused_multi(
        torch.from_numpy(x), torch.from_numpy(inv), torch.from_numpy(cb16),
        [float(a) for a in acts], *[torch.from_numpy(g["packed"]) for g in gs],
        quantize=quantize, nbits=nbits)
    pallas = ref_ops.lut_gemm_fused_multi(
        jnp.asarray(x), jnp.asarray(inv), jnp.asarray(cb16), jnp.asarray(acts),
        *[jnp.asarray(g["packed"]) for g in gs], quantize=quantize, interpret=True,
        nbits=nbits)
    oracle = ref_ref.lut_matmul_fused_multi_ref(
        jnp.asarray(x), [jnp.asarray(g["inv"]) for g in gs],
        [jnp.asarray(g["packed"]) for g in gs], [jnp.asarray(c) for c in cb16],
        [jnp.float32(a) for a in acts], quantize=quantize, nbits=nbits)
    assert len(got) == 3
    for p, (g, y) in enumerate(zip(gs, got)):
        assert tuple(y.shape) == (m, WIDTHS[p]) and y.dtype == torch.float32
        atol = _atol(x, g, quantize[p])
        assert_close(np_of(y), np.asarray(pallas[p]), rtol=1e-5, atol=atol,
                     what=f"projection {p} vs Pallas interpret")
        assert_close(np_of(y), np.asarray(oracle[p]), rtol=1e-5, atol=atol,
                     what=f"projection {p} vs lut_matmul_fused_multi_ref")


def _cts(rng, k, widths, nbits, acts):
    cts = []
    for n, nb, act in zip(widths, nbits, acts):
        codes = rng.integers(0, 1 << nb, (k, n)).astype(np.uint8)
        cb = np.sort(rng.normal(size=1 << nb) * 0.05).astype(np.float32)
        s = rng.uniform(0.5, 1.5, k).astype(np.float32)
        cts.append(port_api.dense_to_clustered(cb[codes] / s[:, None], codes, cb, s, act, nb,
                                               device="cpu"))
    return cts


EQ_CASES = [
    (128, WIDTHS, (4, 4, 4), (0.03,) * 3), (128, WIDTHS, (3, 3, 3), (0.03,) * 3),
    (128, WIDTHS, (2, 2, 2), (None,) * 3), (128, WIDTHS, (4, 2, 2), (0.05, None, 0.05)),
    (128, (256, 256), (2, 4), (0.05, 0.05)), (45, (24, 8, 8), (4, 4, 4), (0.03, 0.03, None)),
    (45, (37, 37), (3, 3), (None, 0.02)), (45, (24, 8, 8), (4, 2, 3), (0.03, None, 0.03)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,widths,nbits,acts", EQ_CASES,
                         ids=[f"k{k}-n{'x'.join(map(str, w))}-b{''.join(map(str, nb))}"
                              for k, w, nb, _ in EQ_CASES])
def test_clustered_linear_multi_is_bit_equal_to_per_projection(k, widths, nbits, acts, dtype):
    rng = np.random.default_rng(k + sum(widths) + sum(nbits))
    cts = _cts(rng, k, widths, nbits, acts)
    x = torch.from_numpy(rng.normal(size=(2, 3, k)).astype(np.float32)).to(dtype)
    fused = port_ops.clustered_linear_multi(x, cts)
    for p, (ct, y) in enumerate(zip(cts, fused)):
        solo = port_ops.clustered_linear(x, ct)
        assert y.shape == (2, 3, widths[p]) and y.dtype == dtype
        assert torch.equal(y, solo), f"projection {p}: fused != solo (must be the same bits)"


def test_clustered_linear_multi_follows_reference_on_dense_to_clustered_tensors():
    """Whole `clustered_linear_multi` against the reference's, tensors built by
    both packages' `dense_to_clustered` from the same numpy weights."""
    from repro.core import api as ref_api
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4, K)).astype(np.float32)
    ref_cts, port_cts, atols = [], [], []
    for n, nb, act in zip(WIDTHS, (4, 2, 3), (0.04, None, 0.04)):
        codes = rng.integers(0, 1 << nb, (K, n)).astype(np.uint8)
        cb = np.sort(rng.normal(size=1 << nb) * 0.05).astype(np.float32)
        s = rng.uniform(0.5, 1.5, K).astype(np.float32)
        w = cb[codes] / s[:, None]
        ref_cts.append(ref_api.dense_to_clustered(w, codes, cb, s, act, nb))
        port_cts.append(port_api.dense_to_clustered(w, codes, cb, s, act, nb, device="cpu"))
        g = dict(codes=codes, cb=cb, inv=1.0 / (s * (act or 1.0)), act=act or 1.0)
        atols.append(_atol(x.reshape(-1, K), g, act is not None).reshape(2, 4, 1))
    with ref_ops.lut_serving("interpret"):
        want = ref_ops.clustered_linear_multi(jnp.asarray(x), tuple(ref_cts))
    got = port_ops.clustered_linear_multi(torch.from_numpy(x), port_cts)
    for p in range(3):
        assert_close(np_of(got[p]), np.asarray(want[p]), rtol=1e-5, atol=atols[p],
                     what=f"clustered_linear_multi projection {p}")


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-1.5b"])
def test_linear_group_fused_on_equals_off(arch):
    model, params = reference_model(arch, n_layers=1)
    rng = np.random.default_rng(8)
    attn = dict(cluster_params(params, 4, act_scale=0.05, smooth_seed=1)["blocks"]["attn"])
    mlp = cluster_params(params, 3, smooth_seed=2)["blocks"]["mlp"]
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = jnp.asarray(rng.normal(size=attn[b].shape).astype(np.float32) * 0.1)
    pa = port_tf.layer_slice(from_reference(to_numpy_tree(attn), device="cpu"), 0)
    pm = port_tf.layer_slice(from_reference(to_numpy_tree(mlp), device="cpu"), 0)
    on = port_model(arch, n_layers=1, fused_projections=True).cfg
    off = port_model(arch, n_layers=1, fused_projections=False).cfg
    x = torch.from_numpy(rng.normal(size=(2, 5, on.d_model)).astype(np.float32))
    port_ops.reset_launch_counts()
    for ws, bs in (((pa["wq"], pa["wk"], pa["wv"]), (pa.get("bq"), pa.get("bk"), pa.get("bv"))),
                   ((pm["w_gate"], pm["w_up"]), (None, None))):
        fused = port_layers.linear_group(x, ws, bs, on)
        plain = port_layers.linear_group(x, ws, bs, off)
        for a, b in zip(fused, plain):
            assert torch.equal(a, b), "fused_projections must not change a bit"
    assert set(port_ops.launch_counts().values()) == {0}, "CPU tensors launch no kernel"
    dense = torch.zeros(on.d_model, 8)
    ys = port_layers.linear_group(x, (pa["wq"], dense), (None, None), on)
    assert ys[1].shape == (2, 5, 8), "a dense weight in the group: independent linears"
    assert torch.equal(ys[0], port_ops.clustered_linear(x, pa["wq"]))


def test_single_projection_and_stacked_codebooks_take_the_solo_path():
    rng = np.random.default_rng(3)
    (ct,) = _cts(rng, 64, (16,), (4,), (0.05,))
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    (y,) = port_ops.clustered_linear_multi(x, [ct])
    assert torch.equal(y, port_ops.clustered_linear(x, ct))
    stacked = port_api.ClusteredTensor(torch.zeros(2, 32, 4, dtype=torch.uint8),
                                       torch.zeros(2, 16), torch.ones(2, 64))
    with pytest.raises(NotImplementedError, match="stacked codebook"):
        port_ops.clustered_linear_multi(x, [stacked, stacked])


def _multi_operands(m=4, k=16, widths=(8, 8), nbits=(4, 4)):
    x = torch.zeros(m, k)
    packed = [torch.zeros(k * nb // 8, n, dtype=torch.uint8) for n, nb in zip(widths, nbits)]
    return x, torch.ones(len(widths), k), torch.zeros(len(widths), 16), packed


def _ref_and_port_errors(x, inv, cb, packed, quantize, nbits):
    """The same bad operands through the reference's `_check_multi` (tile
    sizes chosen so that only the shared checks can fire) and the port's."""
    widths = tuple(int(p.shape[1]) for p in packed)
    m, k = x.shape
    with pytest.raises(ValueError) as r:
        ref_lm._check_multi(jnp.asarray(x.numpy()), jnp.asarray(inv.numpy()),
                            jnp.asarray(cb.numpy()), [jnp.asarray(p.numpy()) for p in packed],
                            widths, quantize, nbits, m, 8, 8, "lut_matmul_fused_multi")
    with pytest.raises(ValueError) as p:
        port_lm.lut_matmul_fused_multi(x, inv, cb, *packed, quantize=quantize, nbits=nbits)
    return str(r.value), str(p.value)


def test_check_multi_value_errors_match_reference():
    x, inv, cb, packed = _multi_operands()
    cases = [
        (x, inv, cb, packed, (True,), (4, 4)),                       # flag count
        (x, inv, cb, packed, (True, True), (4, 4, 4)),               # width count
        (x, torch.ones(3, 16), cb, packed, (True, True), (4, 4)),    # inv_stack rows
        (x, torch.ones(2, 8), cb, packed, (True, True), (4, 4)),     # inv_stack K
        (x, inv, torch.zeros(2, 8), packed, (True, True), (4, 4)),   # codebook padding
        (x, inv, cb, packed, (True, True), (4, 2)),                  # packing width
    ]
    for args in cases:
        want, got = _ref_and_port_errors(*args)
        assert got == want


def test_port_only_errors_name_what_is_wrong():
    x, inv, cb, packed = _multi_operands()
    nine = [packed[0]] * 9
    with pytest.raises(ValueError, match="9 projections; one launch takes at most 8"):
        port_lm.lut_matmul_fused_multi(x, torch.ones(9, 16), torch.zeros(9, 16), *nine,
                                       quantize=(True,) * 9, nbits=(4,) * 9)
    with pytest.raises(ValueError, match=r"M \(128\) must be < 128"):
        port_lm.lut_matmul_fused_multi_gemv(torch.zeros(128, 16), inv, cb, *packed,
                                            quantize=(True, True), nbits=(4, 4))
    with pytest.raises(TypeError, match="x must be float32 or bfloat16"):
        port_lm.lut_matmul_fused_multi(x.double(), inv, cb, *packed, quantize=(True, True),
                                       nbits=(4, 4))
    with pytest.raises(TypeError, match="packed codes of projection 1 must be uint8"):
        port_lm.lut_matmul_fused_multi(x, inv, cb, packed[0], packed[1].to(torch.int8),
                                       quantize=(True, True), nbits=(4, 4))
    with pytest.raises(ValueError, match="inv_stack must be contiguous"):
        port_lm.lut_matmul_fused_multi(x, torch.ones(16, 2).T, cb, *packed,
                                       quantize=(True, True), nbits=(4, 4))
    y = port_lm.lut_matmul_fused_multi_gemv(x, inv, cb, *packed, quantize=(True, False),
                                            nbits=(4, 4))
    assert y.shape == (4, 16) and y.dtype == torch.float32


# ---------------------------------------------------------------------------
# whole steps and the engine in the default configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act_scale", [None, 0.06], ids=["lcd_float", "lcd_quant"])
@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-1.5b"])
def test_paged_decode_step_fused_vs_reference(arch, act_scale):
    """`fused_projections=True` on both sides. On reduced qwen2-1.5b (QKV
    widths 512, 64, 64) the reference's tile widths disagree and it falls
    back to per-projection launches; the port fuses — the logits agree all
    the same."""
    model, params = reference_model(arch, seed=1, n_layers=2, fused_projections=True)
    cfg = model.cfg
    rng = np.random.default_rng(19)
    params = cluster_params(params, 4, smooth_seed=2, act_scale=act_scale)
    S, T, nb, bs = 3, 8, 12, 4
    cache = ref_tf.init_paged_cache(cfg, nb, bs, "float")
    tables = rng.permutation(nb).reshape(S, 4).astype(np.int32)
    pcfg = port_model(arch, n_layers=2, fused_projections=True).cfg
    pparams = from_reference(to_numpy_tree(params), device="cpu")
    pcache = from_reference(to_numpy_tree(cache), device="cpu")
    ref_step = jax.jit(functools.partial(ref_tf.paged_decode_step, cfg=cfg))
    lengths = np.zeros(S, np.int32)
    steps = [(rng.integers(0, cfg.vocab, (S, T)).astype(np.int32), np.array([T, 5, 0], np.int32))]
    steps += [(rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32), np.array([1, 1, 0], np.int32))
              for _ in range(2)]
    port_ops.reset_launch_counts()
    for i, (tokens, n_new) in enumerate(steps):
        with ref_ops.lut_serving("interpret"):
            want, cache = ref_step(params, cache, jnp.asarray(tokens), jnp.asarray(lengths),
                                   jnp.asarray(n_new), jnp.asarray(tables))
        got, pcache = port_tf.paged_decode_step(
            pparams, pcache, torch.from_numpy(tokens), torch.from_numpy(lengths),
            torch.from_numpy(n_new), torch.from_numpy(tables), pcfg)
        live = n_new > 0
        assert_close(np_of(got)[live], np.asarray(want)[live], atol=2e-4,
                     what=f"{arch} fused logits, step {i}")
        lengths = lengths + n_new
    for name in ("k", "v"):
        assert_close(np_of(pcache[name]), np.asarray(cache[name]), rtol=1e-6, atol=1e-5,
                     what=f"{name} pool")


def _drive(engine, prompts, new_tokens):
    """Staggered submissions: a fresh request every other scheduler step."""
    pending, requests = list(prompts), []
    while pending or engine.busy:
        if pending and engine.steps % 2 == 0:
            requests.append(engine.submit(pending.pop(0), max_new_tokens=new_tokens))
        if engine.busy:
            engine.step()
        else:
            engine.steps += 1
    return requests


@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-1.5b"])
def test_engine_tokens_fused_equal_unfused_equal_reference(arch, kv_dtype):
    """The default configuration end to end: the port's engine with and
    without fused projections and the reference's engine (its own default,
    float transform) emit the same greedy tokens for the same staggered
    requests."""
    model, dense = reference_model(arch, seed=2, fused_projections=True)
    params = cluster_params(dense, 4, smooth_seed=5)
    kw = dict(num_slots=3, block_size=4, num_blocks=48, max_blocks_per_slot=12,
              prefill_chunk=8, kv_dtype=kv_dtype)
    kv_smooth = None
    if kv_dtype == "int8":
        kv_smooth = ref_engine.calibrate_kv_smooth(model, params, n_tokens=16, batch=2)
    ref, _ = ref_engine.build_engine(arch, lcd=True, ecfg=ref_engine.EngineConfig(**kw),
                                     params=params, kv_smooth=kv_smooth)
    pparams = from_reference(to_numpy_tree(params), device="cpu")
    psmooth = None if kv_smooth is None else tuple(np_of(s) for s in kv_smooth)
    prompts = [np.random.default_rng(6 + i).integers(0, model.cfg.vocab, 5 + 3 * i)
               .astype(np.int32) for i in range(4)]
    want = [r.out_tokens for r in _drive(ref, prompts, 6)]
    for fused in (True, False):
        engine, _ = port_engine.build_engine(
            arch, lcd=True, ecfg=port_engine.EngineConfig(**kw), params=pparams,
            kv_smooth=psmooth, fused_projections=fused, device="cpu")
        got = [r.out_tokens for r in _drive(engine, prompts, 6)]
        assert got == want, (f"fused_projections={fused}: port {got} vs reference {want}; "
                             f"check the reference's top-2 logit margin before calling it "
                             f"a fault")
        engine.assert_bounded_traces()
        assert set(engine.traces) == {1, 8}
