"""The port's static-batch path against the reference: the contiguous-cache
attention (`attention`, `attn_block` with a float or int8 cache), the whole
`decode_step`, `build_decode_fns` and `serve()` with exact greedy tokens on
reduced f32 configs, the static tokens against the port's own paged engine,
`calibrate_kv_smooth` and `kv_capacity_report`, and the CLI's static mode.

The reference runs on the CPU, its Pallas kernels in interpret mode for the
LCD runs. Tolerances: attention f32 2e-6, bf16 one bf16 ulp of the output
scale (2^-7, the probabilities are held in bf16 on both sides); logits 2e-4;
float caches 1e-5; int8 cache codes exact, their scales 1e-6; smoothing
vectors rtol 1e-4 (they are functions of captured K/V, which agree to f32
rounding)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import lut_serving
from repro.launch import engine as ref_engine
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.convert import from_reference
from repro_torch.core import clustered_params as port_cp
from repro_torch.core.api import is_clustered
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_tf

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (assert_close, assert_equal, cluster_params, np_of, port_model,
                  reference_model, to_numpy_tree, with_act_scale)

pytestmark = pytest.mark.tier1

ARCHS = ("llama2-7b", "qwen2-1.5b")


def _port(tree):
    return from_reference(to_numpy_tree(tree), device="cpu")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

ATTN = [dict(), dict(window=3), dict(softcap=5.0), dict(q_offset=4), dict(chunk=4),
        dict(window=2, softcap=3.0, q_offset=3, chunk=2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", ATTN, ids=lambda kw: "-".join(kw) or "plain")
def test_attention_vs_reference(kw, dtype):
    rng = np.random.default_rng(len(kw))
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 10, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 10, 2, 16)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = ref_layers.attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), **kw)
    tdt = getattr(torch, dtype)
    got = port_layers.attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    assert got.dtype == tdt and tuple(got.shape) == (2, 6, 4, 16)
    tol = 2e-6 if dtype == "float32" else 2.0 ** -7 * float(np.abs(np_of(want)).max())
    assert_close(np_of(got), np_of(want), atol=tol, what=f"attention {kw}")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_block_with_cache_vs_reference(arch, kv):
    model, params = reference_model(arch, n_layers=1, kv_cache_dtype=kv)
    cfg = model.cfg
    rng = np.random.default_rng(5)
    attn = dict(params["blocks"]["attn"])
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = jnp.asarray(rng.normal(size=attn[b].shape).astype(np.float32) * 0.1)
    p_ref = jax.tree_util.tree_map(lambda a: a[0], attn)
    p_port = port_tf.layer_slice(_port(attn), 0)
    pcfg = port_model(arch, n_layers=1, kv_cache_dtype=kv).cfg
    ref_cache = {k: v[0] for k, v in ref_tf.init_cache(cfg, 2, 9).items() if k != "pos"}
    port_cache = {k: v[0] for k, v in port_tf.init_cache(pcfg, 2, 9, device="cpu").items()
                  if k != "pos"}
    pos = 0
    for s in (5, 1, 1):                          # a prompt, then two decode steps
        x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
        want, new = ref_layers.attn_block(p_ref, jnp.asarray(x), cfg,
                                          cache={**ref_cache, "pos": jnp.int32(pos)})
        ref_cache = {k: v for k, v in new.items() if k != "pos"}
        got = port_layers.attn_block(p_port, torch.from_numpy(x), pcfg,
                                     cache={**port_cache, "pos": pos})
        assert_close(np_of(got), np.asarray(want), rtol=1e-4, atol=2e-5,
                     what=f"attn_block output at pos {pos}")
        pos += s
        assert int(new["pos"]) == pos
    for name, want in ref_cache.items():
        if want.dtype == jnp.int8:
            assert_equal(np_of(port_cache[name]), np.asarray(want), f"{name} (int8 codes)")
        else:
            assert_close(np_of(port_cache[name]), np.asarray(want), rtol=1e-6,
                         atol=1e-6 if "scale" in name else 1e-5, what=name)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_block_with_a_device_pos_vs_reference(arch, kv):
    """`pos` as a 0-d int32 tensor, as the static decode graph passes it: a
    prompt, then two decode steps, against the reference at the same
    tolerances as the host-int case; the block leaves `pos` to its caller."""
    model, params = reference_model(arch, n_layers=1, kv_cache_dtype=kv)
    cfg = model.cfg
    rng = np.random.default_rng(8)
    p_ref = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["attn"])
    p_port = port_tf.layer_slice(_port(params["blocks"]["attn"]), 0)
    pcfg = port_model(arch, n_layers=1, kv_cache_dtype=kv).cfg
    ref_cache = {k: v[0] for k, v in ref_tf.init_cache(cfg, 2, 9).items() if k != "pos"}
    port_cache = {k: v[0] for k, v in port_tf.init_cache(pcfg, 2, 9, device="cpu").items()
                  if k != "pos"}
    pos = 0
    for s in (6, 1, 1):
        x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
        want, new = ref_layers.attn_block(p_ref, jnp.asarray(x), cfg,
                                          cache={**ref_cache, "pos": jnp.int32(pos)})
        ref_cache = {k: v for k, v in new.items() if k != "pos"}
        tpos = torch.tensor(pos, dtype=torch.int32)
        got = port_layers.attn_block(p_port, torch.from_numpy(x), pcfg,
                                     cache={**port_cache, "pos": tpos})
        assert int(tpos) == pos, "attn_block must not advance pos"
        assert_close(np_of(got), np.asarray(want), rtol=1e-4, atol=2e-5,
                     what=f"attn_block output at device pos {pos}")
        pos += s
    for name, want in ref_cache.items():
        if want.dtype == jnp.int8:
            assert_equal(np_of(port_cache[name]), np.asarray(want), f"{name} (int8 codes)")
        else:
            assert_close(np_of(port_cache[name]), np.asarray(want), rtol=1e-6,
                         atol=1e-6 if "scale" in name else 1e-5, what=name)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_step_writes_at_a_device_pos_and_advances_the_cache_pos_in_place(kv):
    """A fresh cache's `pos` is a 0-d int32 tensor equal to 0; `decode_step`
    writes at the `pos` it is given (here a tensor other than the cache's)
    and leaves pos + S in the cache's own tensor, the same object, as the
    reference leaves pos + S in its new cache."""
    arch = "llama2-7b"
    model, params = reference_model(arch, seed=3, n_layers=1, kv_cache_dtype=kv,
                                     fused_projections=True)
    cfg = model.cfg
    pmodel = port_model(arch, n_layers=1, kv_cache_dtype=kv, fused_projections=True)
    pcache = pmodel.init_cache(2, 9, device="cpu")
    pos_t = pcache["pos"]
    assert pos_t.dtype == torch.int32 and pos_t.ndim == 0 and pos_t == 0
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    want, cache = ref_tf.decode_step(params, ref_tf.init_cache(cfg, 2, 9), jnp.asarray(tokens),
                                     jnp.int32(3), cfg)
    got, out = port_tf.decode_step(_port(params), pcache, torch.from_numpy(tokens),
                                   torch.tensor(3, dtype=torch.int32), pmodel.cfg)
    assert out is pcache and out["pos"] is pos_t and int(pos_t) == int(cache["pos"]) == 7
    assert_close(np_of(got), np.asarray(want), atol=2e-4, what="logits at pos 3")
    for name in ("k", "v"):
        if cache[name].dtype == jnp.int8:
            assert_equal(np_of(out[name]), np.asarray(cache[name]), f"{name} (int8 codes)")
        else:
            assert_close(np_of(out[name]), np.asarray(cache[name]), rtol=1e-6, atol=1e-5,
                         what=f"{name} cache")


@pytest.mark.parametrize("gen", [1, 2])
def test_build_decode_fns_short_generations_equal_reference(gen):
    """One and two generated tokens: the first column is the prefill's
    token, and a single step needs no replay."""
    arch = "qwen2-1.5b"
    model, params = reference_model(arch, seed=6, fused_projections=True)
    pmodel = port_model(arch, fused_projections=True)
    prompt = np.random.default_rng(2).integers(0, model.cfg.vocab, (2, 5)).astype(np.int32)
    prefill, decode, _ = ref_engine.build_decode_fns(model, model.cfg, gen)
    tok, cache = prefill(params, model.init_cache(2, 5 + gen), jnp.asarray(prompt))
    want, _ = decode(params, cache, tok)
    pprefill, pdecode, ptraces = port_engine.build_decode_fns(pmodel, pmodel.cfg, gen)
    ptok, pcache = pprefill(_port(params), pmodel.init_cache(2, 5 + gen, device="cpu"),
                            torch.from_numpy(prompt))
    got, pcache = pdecode(_port(params), pcache, ptok)
    assert_equal(np_of(got), np.asarray(want), f"greedy tokens, {gen} generated")
    assert_equal(np_of(got)[:, :1], np_of(ptok), "first column = the prefill's token")
    assert int(pcache["pos"]) == 5 + gen and ptraces == {"prefill": 1, "decode": 1}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_init_cache_matches_reference(kv):
    for arch in ARCHS:
        model, _ = reference_model(arch, kv_cache_dtype=kv)
        pm = port_model(arch, kv_cache_dtype=kv)
        rc = ref_tf.init_cache(model.cfg, 3, 7)
        pc = pm.init_cache(3, 7, device="cpu")
        assert sorted(pc) == sorted(rc) and pc["pos"] == 0
        for k in rc:
            if k != "pos":
                assert_equal(np_of(pc[k]), np.asarray(rc[k]), f"fresh {kv} cache {k}")
                assert np_of(pc[k]).dtype == np.asarray(rc[k]).dtype or kv != "int8"


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

VARIANTS = {"dense": None, "lcd_float": dict(act_scale=None), "lcd_quant": dict(act_scale=0.06)}
STEP_CASES = [(a, v, "bf16") for a in ARCHS for v in VARIANTS] + [
    ("llama2-7b", "lcd_quant", "int8"), ("qwen2-1.5b", "dense", "int8")]


@pytest.mark.parametrize("arch,variant,kv", STEP_CASES,
                         ids=[f"{a}-{v}-{k}" for a, v, k in STEP_CASES])
def test_decode_step_vs_reference(arch, variant, kv):
    """A prompt of 6 and three one-token steps through the whole stack, the
    default fused configuration on both sides; logits and the cache."""
    model, params = reference_model(arch, seed=1, n_layers=2, kv_cache_dtype=kv,
                                    fused_projections=True)
    cfg = model.cfg
    rng = np.random.default_rng(21)
    if VARIANTS[variant] is not None:
        params = cluster_params(params, 4, smooth_seed=3, **VARIANTS[variant])
    pmodel = port_model(arch, n_layers=2, kv_cache_dtype=kv, fused_projections=True)
    pparams = _port(params)
    cache = ref_tf.init_cache(cfg, 2, 9)
    pcache = pmodel.init_cache(2, 9, device="cpu")
    ref_step = jax.jit(functools.partial(ref_tf.decode_step, cfg=cfg))
    feeds = [rng.integers(0, cfg.vocab, (2, 6))] + [rng.integers(0, cfg.vocab, (2, 1))
                                                    for _ in range(3)]
    for i, tokens in enumerate(feeds):
        tokens = tokens.astype(np.int32)
        with lut_serving("interpret" if variant != "dense" else None):
            want, cache = ref_step(params, cache, jnp.asarray(tokens), cache["pos"])
        got, pcache = pmodel.decode(pparams, pcache, {"tokens": torch.from_numpy(tokens),
                                                      "pos": pcache["pos"]})
        assert got.shape == (2, cfg.padded_vocab) and pcache["pos"] == int(cache["pos"])
        assert_close(np_of(got), np.asarray(want), atol=2e-4, what=f"logits, step {i}")
    for name, want in cache.items():
        if name == "pos":
            continue
        if want.dtype == jnp.int8:
            assert_equal(np_of(pcache[name]), np.asarray(want), f"{name} (int8 codes)")
        else:
            assert_close(np_of(pcache[name]), np.asarray(want), rtol=1e-6,
                         atol=1e-6 if "scale" in name else 1e-5, what=f"{name} cache")


@pytest.mark.parametrize("variant", ["dense", "lcd_quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_decode_fns_greedy_tokens_equal_reference(arch, variant):
    model, params = reference_model(arch, seed=4, fused_projections=True)
    if VARIANTS[variant] is not None:
        params = cluster_params(params, 4, smooth_seed=6, **VARIANTS[variant])
    pmodel = port_model(arch, fused_projections=True)
    pparams = _port(params)
    prompt = np.random.default_rng(9).integers(0, model.cfg.vocab, (2, 6)).astype(np.int32)
    gen = 5
    with lut_serving("interpret" if variant != "dense" else None):
        prefill, decode, traces = ref_engine.build_decode_fns(model, model.cfg, gen)
        tok, cache = prefill(params, model.init_cache(2, 6 + gen), jnp.asarray(prompt))
        want, _ = decode(params, cache, tok)
    pprefill, pdecode, ptraces = port_engine.build_decode_fns(pmodel, pmodel.cfg, gen)
    for _ in range(2):            # a second generation of the same shapes adds no shape
        ptok, pcache = pprefill(pparams, pmodel.init_cache(2, 6 + gen, device="cpu"),
                                torch.from_numpy(prompt))
        got, pcache = pdecode(pparams, pcache, ptok)
        assert got.dtype == torch.int32 and tuple(got.shape) == (2, gen)
        assert_equal(np_of(got), np.asarray(want), f"{arch}/{variant} greedy tokens")
        assert pcache["pos"] == 6 + gen
    assert ptraces == traces == {"prefill": 1, "decode": 1}


def _armed(tree):
    """Every clustered leaf with the quantized Eq. 11 transform armed."""
    if is_clustered(tree):
        return with_act_scale(tree, 0.05)
    return {k: _armed(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


@pytest.mark.parametrize("quantized", [False, True], ids=["float_tf", "quant_tf"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_tokens_equal_the_paged_engine_tokens(arch, quantized):
    """The port's two serving paths agree: one prompt through
    `build_decode_fns` and alone through the `ServingEngine` (the mirror of
    the reference's own static-vs-paged test)."""
    model = port_model(arch, n_layers=2, fused_projections=True)
    params = port_cp.materialize_clustered(model, torch.Generator().manual_seed(7), nbits=4,
                                           device="cpu")
    if quantized:
        params = _armed(params)
    gen = 5
    prefill, decode, _ = port_engine.build_decode_fns(model, model.cfg, gen)
    ecfg = port_engine.EngineConfig(num_slots=2, block_size=4, num_blocks=8,
                                    max_blocks_per_slot=4, prefill_chunk=8)
    for seed in range(3):
        prompt = np.random.default_rng(seed).integers(0, model.cfg.vocab, 6).astype(np.int32)
        tok, cache = prefill(params, model.init_cache(1, 6 + gen, device="cpu"),
                             torch.from_numpy(prompt[None]))
        static, _ = decode(params, cache, tok)
        engine = port_engine.ServingEngine(model, params, ecfg, device="cpu")
        r = engine.submit(prompt, max_new_tokens=gen)
        engine.run()
        assert r.out_tokens == np_of(static)[0].tolist(), f"prompt {seed}: static != paged"


# ---------------------------------------------------------------------------
# int8 KV calibration and capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_kv_smooth_vs_reference(arch):
    model, dense = reference_model(arch, seed=3)
    params = cluster_params(dense, 4, smooth_seed=1)
    want = ref_engine.calibrate_kv_smooth(model, params, n_tokens=16, batch=2, seed=2)
    pmodel = port_model(arch, fused_projections=True)
    got = port_engine.calibrate_kv_smooth(pmodel, _port(params), n_tokens=16, batch=2, seed=2)
    shape = (model.cfg.n_layers, model.cfg.n_kv_heads, model.cfg.hd)
    for name, w, g in zip(("k_smooth", "v_smooth"), want, got):
        assert g.shape == shape and g.dtype == np.float32
        # a different winner would differ by far more than this (identity vs
        # a 0.5 scalar vs an alpha vector)
        assert_close(g, np.asarray(w), rtol=1e-4, atol=1e-6, what=name)
    assert not np.all(got[0] == 1.0), "some head should prefer a non-identity candidate"


def test_kv_capacity_report_equals_reference():
    from repro.models.config import get_config as ref_get_config
    from repro_torch.models.config import get_config as port_get_config
    for arch in ARCHS:
        for kw in (dict(), dict(num_blocks=256, block_size=16, max_blocks_per_slot=32)):
            rcfg, pcfg = ref_get_config(arch), port_get_config(arch)
            for tokens in (40, 264):
                want = ref_engine.kv_capacity_report(rcfg, ref_engine.EngineConfig(**kw), tokens)
                got = port_engine.kv_capacity_report(pcfg, port_engine.EngineConfig(**kw),
                                                     tokens)
                assert got == want
            for dt in ("float", "int8"):
                assert (port_engine.paged_kv_bytes_per_block(pcfg, 16, dt)
                        == ref_engine.paged_kv_bytes_per_block(rcfg, 16, dt))


@pytest.mark.usefixtures("one_torch_thread")   # --lcd compresses on the CPU
def test_build_engine_calibrates_the_int8_pool():
    engine, params = port_engine.build_engine(
        "llama2-7b", lcd=True, n_layers=2, device="cpu",
        ecfg=port_engine.EngineConfig(kv_dtype="int8", num_blocks=32))
    pool = engine.caches["paged"]
    want = port_engine.calibrate_kv_smooth(engine.model, params)
    assert_equal(np_of(pool["k_smooth"]), want[0], "installed k_smooth")
    assert_equal(np_of(pool["v_smooth"]), want[1], "installed v_smooth")
    r = engine.submit(np.arange(5), max_new_tokens=3)
    engine.run()
    assert len(r.out_tokens) == 3


# ---------------------------------------------------------------------------
# serve() and the CLI's static mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_equals_the_reference_static_path_on_the_same_dense_params(arch):
    """`serve()` draws its prompts as the reference's `serve()` does and
    decodes them through the static path; the reference's two computations
    (`build_decode_fns`) on the same params and prompts give the same tokens.
    (The reference's `serve()` itself wraps them in a host mesh whose
    sharding rules this JAX build refuses for the contiguous cache.)"""
    model, params = reference_model(arch, seed=5, fused_projections=True)
    batch, prompt_len, gen = 2, 6, 4
    prompt = np.random.default_rng(3).integers(0, model.cfg.vocab, (batch, prompt_len))
    prefill, decode, _ = ref_engine.build_decode_fns(model, model.cfg, gen)
    tok, cache = prefill(params, model.init_cache(batch, prompt_len + gen),
                         jnp.asarray(prompt, jnp.int32))
    want, _ = decode(params, cache, tok)
    stats = {}
    got, _ = port_engine.serve(arch, batch=batch, prompt_len=prompt_len, gen_tokens=gen,
                               seed=3, params=_port(params), stats=stats, device="cpu")
    assert_equal(got, np.asarray(want), f"{arch} serve() tokens")
    assert stats["traces"] == {"prefill": 1, "decode": 1}
    assert stats["batch"] == 2 and stats["gen_tokens"] == 4 and stats["tokens_per_s"] > 0


@pytest.mark.usefixtures("one_torch_thread")   # --lcd compresses on the CPU
def test_serve_lcd_and_the_static_cli_on_the_cpu():
    gen, params = port_engine.serve("llama2-7b", lcd=True, batch=2, prompt_len=5,
                                    gen_tokens=3, weight_bits=3, device="cpu")
    assert gen.shape == (2, 3) and params["blocks"]["mlp"]["w_up"].nbits == 3
    out = port_serve.main(["--arch", "qwen2-1.5b", "--reduced", "--lcd", "--batch", "2",
                           "--tokens", "3", "--prompt-len", "5", "--bits", "2",
                           "--device", "cpu"])
    assert out.shape == (2, 3) and ((0 <= out) & (out < 151936)).all()
    unfused = port_serve.main(["--arch", "qwen2-1.5b", "--reduced", "--lcd", "--batch", "2",
                               "--tokens", "3", "--prompt-len", "5", "--bits", "2",
                               "--no-fused-projections", "--device", "cpu"])
    assert_equal(unfused, out, "static CLI tokens, fused vs per-projection")
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "llama2-7b", "--reduced", "--kv-dtype", "int8",
                         "--device", "cpu"])


@pytest.mark.usefixtures("one_torch_thread")   # --lcd compresses on the CPU
def test_serve_refuses_what_needs_the_compression_pipeline():
    """What used to be refused for want of the compression pipeline now runs
    through it: a bits budget, and dense params with lcd=True."""
    stats = {}
    gen, params = port_engine.serve("llama2-7b", lcd=True, bits_budget=3.0, batch=1,
                                    prompt_len=4, gen_tokens=2, stats=stats, device="cpu")
    assert gen.shape == (1, 2) and stats["mean_packed_bits"] <= 3.0
    model = port_model("llama2-7b", fused_projections=True)
    dense = model.init(torch.Generator().manual_seed(0), device="cpu")
    gen, params = port_engine.serve("llama2-7b", lcd=True, params=dense, batch=1,
                                    prompt_len=4, gen_tokens=2, device="cpu")
    assert gen.shape == (1, 2) and params["blocks"]["attn"]["wq"].nbits == 4
