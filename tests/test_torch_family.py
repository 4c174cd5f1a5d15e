"""The rest of the transformer family in the port — gemma2-27b (alternating
local/global windows, attention and final softcaps), starcoder2-15b
(layernorm, the gelu MLP with biases, QKV bias), stablelm-12b (layernorm,
head_dim 160) and paligemma-3b (the vlm family's text decoder: 16-into-1 GQA
over padded heads, head_dim 256) — against the reference on `reduced()`
configs, and the contracts the reference asserts within itself re-asserted
within the port: engine = solo, fused = unfused, spec = plain greedy.

Also the layernorm statistic's row count: a row gets the same bits whether it
is normed alone or among 32 or 256 rows (`models/layers.py _stat_rows`).

Tolerances: configs, tables, windows, block tables, launch plans and greedy
tokens exact; logits atol 2e-4 (dense, the float and the quantized
transform, the same inputs through both packages), float pools 1e-5, int8 KV
codes exact and scales 1e-6 (over an int8 pool with LCD weights a code may
be one step off, see `test_paged_decode_step_logits_and_pools`), layernorm
1e-5."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import lut_serving
from repro.launch import engine as ref_engine
from repro.models import config as ref_config
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.convert import from_reference
from repro_torch.core import clustered_params as port_cp
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.models import config as port_config
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_tf
from repro_torch.models.params import iter_table
from repro_torch.models.registry import PORTED_FAMILIES, get_model

# many small ops: with the suite's workers sharing the cores, torch's parallel
# regions wait on descheduled threads, so every test runs on one thread
from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (assert_close, assert_equal, both, cluster_params, np_of,
                  port_model, reference_model, to_numpy_tree)

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

ARCHS = ("gemma2-27b", "starcoder2-15b", "stablelm-12b", "paligemma-3b")
BIASES = ("bq", "bk", "bv", "b_up", "b_down", "bias")


def _port_tree(tree):
    return from_reference(to_numpy_tree(tree), device="cpu")


def _lively(params, seed):
    """The reference's dense params with every bias and norm scale moved off
    its zero / one initialisation, so that each one counts."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in BIASES or k == "scale":
                out[k] = v + jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1)
            else:
                out[k] = v
        return out
    return walk(params)


# ---------------------------------------------------------------------------
# layernorm's statistic (the row-count repair) and the layers the archs add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 4, 8, 15, 16])
def test_layernorm_row_bits_do_not_depend_on_the_row_count(r):
    """r rows normed alone are torch.equal to the same rows taken out of a
    32-row and a 256-row call, and match the reference's layernorm to 1e-5."""
    rng = np.random.default_rng(r)
    d = 160
    x = (rng.normal(size=(256, d)) * 3 + 1).astype(np.float32)
    scale = (1 + rng.normal(size=d) * 0.1).astype(np.float32)
    bias = (rng.normal(size=d) * 0.1).astype(np.float32)
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        alone = port_layers.layernorm(xt[:r], s, b)
        for n in (32, 256):
            assert torch.equal(alone, port_layers.layernorm(xt[:n], s, b)[:r]), (dtype, n)
        # a (S, T, d) activation: the same bits as its rows normed flat
        assert torch.equal(port_layers.layernorm(xt[:r].view(1, r, d), s, b)[0], alone)
    want, got = both(ref_layers.layernorm, port_layers.layernorm, x[:r], scale, bias)
    assert_close(got, want, rtol=1e-5, atol=1e-5, what=f"layernorm, {r} rows")


def test_gelu_mlp_block_with_biases_and_linear_group_bias_of_one():
    """The gelu MLP (the tanh form of `jax.nn.gelu`, biases after each
    projection) of reduced starcoder2-15b against the reference, dense and
    LCD; and `linear_group`'s bias add for a group of one projection."""
    model, dense = reference_model("starcoder2-15b", n_layers=1)
    dense = _lively(dense, 3)
    cfg = port_model("starcoder2-15b", n_layers=1).cfg
    x = np.random.default_rng(4).normal(size=(2, 3, 128)).astype(np.float32)
    for lcd in (False, True):
        params = cluster_params(dense, 4, smooth_seed=3) if lcd else dense
        p_ref = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["mlp"])
        p_port = port_tf.layer_slice(_port_tree(params["blocks"]["mlp"]), 0)
        with lut_serving("interpret" if lcd else None):
            want = np.asarray(ref_layers.mlp_block(p_ref, jnp.asarray(x), model.cfg))
        got = np_of(port_layers.mlp_block(p_port, torch.from_numpy(x), cfg))
        assert_close(got, want, rtol=1e-4, atol=2e-5, what=f"gelu mlp_block lcd={lcd}")
        (one,) = port_layers.linear_group(torch.from_numpy(x), (p_port["w_up"],),
                                          (p_port["b_up"],), cfg)
        assert torch.equal(one, port_layers.linear(torch.from_numpy(x), p_port["w_up"],
                                                   p_port["b_up"]))


# ---------------------------------------------------------------------------
# configs, tables, windows
# ---------------------------------------------------------------------------

DERIVED = ("hd", "padded_vocab", "n_heads_eff", "q_dim_eff", "q_dim", "kv_dim")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_config_equal_the_reference(arch):
    """Every field and derived width of the registered config and of its
    `reduced()` form (window 16 for gemma2, 8 image tokens for paligemma,
    the head-padding rule) equals the reference's, field by field."""
    for make in (lambda m, a: m.get_config(a), lambda m, a: m.reduced(m.get_config(a))):
        ref, port = make(ref_config, arch), make(port_config, arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for f in DERIVED:
            assert getattr(port, f) == getattr(ref, f), f
    assert arch in port_config.list_archs()
    assert get_model(arch).cfg.family in PORTED_FAMILIES


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_table_windows_and_caches_equal_the_reference(arch, full):
    """`param_table` keys, shapes, sharding names, inits and dtypes, the
    per-layer windows and the fresh paged caches equal the reference's."""
    if full:
        rcfg, pcfg = ref_config.get_config(arch), port_config.get_config(arch)
    else:
        rcfg, pcfg = reference_model(arch)[0].cfg, port_model(arch).cfg
    rt, pt = ref_tf.param_table(rcfg), port_tf.param_table(pcfg)
    ref_decl = {jax.tree_util.keystr(kp): d for kp, d in jax.tree_util.tree_flatten_with_path(
        rt, is_leaf=lambda d: hasattr(d, "names"))[0]}
    port = dict(iter_table(pt))
    assert sorted(port) == sorted(ref_decl)
    for path, d in port.items():
        r = ref_decl[path]
        assert (d.shape, d.names, d.init, d.dtype) == (r.shape, r.names, r.init, r.dtype), path
    assert_equal(port_tf.layer_windows(pcfg), ref_tf.layer_windows(rcfg), "windows")
    if arch == "gemma2-27b":           # even layers local, odd global
        w = port_tf.layer_windows(pcfg)
        assert (w[0::2] == pcfg.local_window).all() and (w[1::2] == 0).all()
    if not full:
        for kv in ("float", "int8"):
            rc = ref_tf.init_paged_cache(rcfg, 6, 4, kv)
            pc = port_tf.init_paged_cache(pcfg, 6, 4, kv, device="cpu")
            assert sorted(rc) == sorted(pc)
            for k in rc:
                assert_equal(np_of(pc[k]), np.asarray(rc[k]), f"fresh {kv} cache {k}")
        for kv in ("float", "int8"):
            assert port_engine.paged_kv_bytes_per_block(pcfg, 16, kv) == \
                ref_engine.paged_kv_bytes_per_block(rcfg, 16, kv)


@pytest.mark.parametrize("arch", ARCHS)
def test_clustered_eligibility_and_shapes_equal_the_reference(arch):
    """Every projection clustered, every bias, norm leaf, embedding and head
    dense: the rule and the clustered shapes are the reference's."""
    from repro.core import clustered_params as ref_cp
    model, _ = reference_model(arch)
    pm = port_model(arch)
    _, _, ref_stats = ref_cp.clustered_abstract(model, nbits=4)
    shapes, stats = port_cp.clustered_abstract(pm, nbits=4)
    assert stats == ref_stats
    flat = jax.tree_util.tree_flatten_with_path(
        model.table, is_leaf=lambda d: hasattr(d, "names"))[0]
    want = {jax.tree_util.keystr(kp): ref_cp._eligible(jax.tree_util.keystr(kp), d)
            for kp, d in flat}
    got = {path: port_cp._eligible(path, d) for path, d in iter_table(pm.table)}
    assert got == want
    n_proj = 6 if pm.cfg.mlp == "gelu" else 7
    assert sum(got.values()) == n_proj
    assert not any(v for p, v in got.items() if any(f"'{b}'" in p for b in BIASES))


# ---------------------------------------------------------------------------
# whole paged steps against the reference
# ---------------------------------------------------------------------------

VARIANTS = {"dense": None, "lcd_float": dict(act_scale=None), "lcd_quant": dict(act_scale=0.06)}


def _steps(cfg, S, T, rng):
    """Two prefill chunks (slot 1 idle throughout, ragged chunk lengths),
    then three decode steps: slot 0 ends past reduced gemma2's window of 16."""
    n_first = np.array([T, 0, T - 3, 2][:S], np.int32)
    steps = [(rng.integers(0, cfg.vocab, (S, T)).astype(np.int32), n_first)]
    steps.append((rng.integers(0, cfg.vocab, (S, T)).astype(np.int32),
                  np.where(n_first > 0, T, 0).astype(np.int32)))
    for _ in range(3):
        steps.append((rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32),
                      (n_first > 0).astype(np.int32)))
    return steps


# every variant over the float pool, the served one (lcd_quant) over the int8 pool too
STEP_CASES = [(v, "float") for v in VARIANTS] + [("lcd_quant", "int8")]


@pytest.mark.parametrize("variant,kv_dtype", STEP_CASES, ids=lambda c: c)
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_logits_and_pools(arch, variant, kv_dtype):
    """Two prefill chunks and three decode steps of the port's paged step
    against the reference's on the same converted params and pools. Over an
    int8 pool with LCD weights the two packages' f32 LUT sums run in another
    order, so a K / V element on a rounding boundary can take the
    neighbouring int8 code, which moves the logits by far more than an f32
    ulp (the quantizer is discontinuous): there the codes are held to one
    step on at most 0.1 % of the entries, and the logits to the port's own
    width-1 steps (the engine and spec tests below) instead of the
    reference's."""
    model, params = reference_model(arch, seed=1, n_layers=2)
    cfg = model.cfg
    params = _lively(params, 17)
    if VARIANTS[variant] is not None:
        params = cluster_params(params, 4, smooth_seed=2, **VARIANTS[variant])
    rng = np.random.default_rng(17)
    S, T, nb, bs, nbw = 4, 8, 24, 4, 6
    cache = ref_tf.init_paged_cache(cfg, nb, bs, kv_dtype)
    if kv_dtype == "int8":
        for k in ("k_smooth", "v_smooth"):
            cache[k] = jnp.asarray(rng.uniform(0.5, 2, cache[k].shape), jnp.float32)
    tables = rng.permutation(nb).reshape(S, nbw).astype(np.int32)
    steps = _steps(cfg, S, T, rng)
    pcfg = port_model(arch, n_layers=2).cfg
    pparams, pcache = _port_tree(params), _port_tree(cache)
    ref_step = jax.jit(functools.partial(ref_tf.paged_decode_step, cfg=cfg))
    lengths = np.zeros(S, np.int32)
    live = steps[0][1] > 0
    for i, (tokens, n_new) in enumerate(steps):
        with lut_serving("interpret" if variant != "dense" else None):
            want, cache = ref_step(params, cache, jnp.asarray(tokens), jnp.asarray(lengths),
                                   jnp.asarray(n_new), jnp.asarray(tables))
        got, pcache = port_tf.paged_decode_step(
            pparams, pcache, torch.from_numpy(tokens), torch.from_numpy(lengths),
            torch.from_numpy(n_new), torch.from_numpy(tables), pcfg)
        assert got.shape == (S, cfg.padded_vocab)
        if cfg.final_softcap:
            assert float(got.abs().max()) <= cfg.final_softcap
        if not (flips := kv_dtype == "int8" and variant != "dense"):
            assert_close(np_of(got)[live], np.asarray(want)[live], atol=2e-4,
                         what=f"{arch}/{variant}/{kv_dtype} logits, step {i}")
        lengths = lengths + n_new
    assert lengths.max() > cfg.local_window
    for name, want in cache.items():
        got = np_of(pcache[name])
        if want.dtype == jnp.int8 and flips:
            step = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
            assert step.max() <= 1 and (step > 0).mean() <= 1e-3, f"{name} pool codes"
        elif want.dtype == jnp.int8:
            assert_equal(got, np.asarray(want), f"{name} pool (int8 codes)")
        elif flips and "scale" in name:
            # a code one step off upstream moves one K / V element by its
            # scale (1 / 127 of the row's absmax): later rows' absmax by ~1 %
            assert_close(got, np.asarray(want), rtol=1e-2, what=f"{name} pool")
        else:
            assert_close(got, np.asarray(want), rtol=1e-6,
                         atol=1e-6 if "scale" in name else 1e-5, what=f"{name} pool")


def test_gemma2_local_and_global_layers_give_different_outputs():
    """Twin of the reference's local/global test, on the paged step: with a
    window of 4 the even layers must not see past it, so the same tokens
    give other logits than with every layer global, and the step agrees
    with the reference's either way."""
    for pattern in ("alt_local_global", "global"):
        model, params = reference_model("gemma2-27b", seed=5, n_layers=2, local_window=4,
                                        layer_pattern=pattern)
        pcfg = port_model("gemma2-27b", n_layers=2, local_window=4, layer_pattern=pattern).cfg
        assert list(port_tf.layer_windows(pcfg)) == ([4, 0] if pattern != "global" else [0, 0])
        rng = np.random.default_rng(8)
        tokens = rng.integers(0, pcfg.vocab, (2, 12)).astype(np.int32)
        tables = np.arange(8, dtype=np.int32).reshape(2, 4)
        lengths, n_new = np.zeros(2, np.int32), np.array([12, 7], np.int32)
        cache = ref_tf.init_paged_cache(model.cfg, 8, 4, "float")
        want, _ = ref_tf.paged_decode_step(params, cache, jnp.asarray(tokens),
                                           jnp.asarray(lengths), jnp.asarray(n_new),
                                           jnp.asarray(tables), model.cfg)
        got, _ = port_tf.paged_decode_step(
            _port_tree(params), _port_tree(cache), torch.from_numpy(tokens),
            torch.from_numpy(lengths), torch.from_numpy(n_new), torch.from_numpy(tables), pcfg)
        assert_close(np_of(got), np.asarray(want), atol=2e-4, what=f"{pattern} logits")
        if pattern == "global":
            assert float(np.abs(np_of(got) - local).max()) > 1e-3
        local = np_of(got)


# ---------------------------------------------------------------------------
# the engine: within the port, and against the reference engine
# ---------------------------------------------------------------------------

ECFG = dict(num_slots=3, block_size=4, num_blocks=40, max_blocks_per_slot=10,
            prefill_chunk=8)


def _prompts(vocab, n, seed, lo=3, hi=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


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
    engine.assert_bounded_traces()
    return requests


@functools.lru_cache(maxsize=None)
def _lcd_reference(arch, act_scale):
    """(reference model, reference clustered params): reduced (4 layers),
    biases and norms moved off their initialisation, 4-bit."""
    model, dense = reference_model(arch, seed=2)
    return model, cluster_params(_lively(dense, 9), 4, smooth_seed=5, act_scale=act_scale)


def _lcd_port(arch, fused=False):
    """(port model, the same clustered params converted), quantized transform."""
    _, params = _lcd_reference(arch, 0.06)
    return port_model(arch, fused_projections=fused), _port_tree(params)


def _smooth(cfg, kv_dtype):
    ones = np.ones((cfg.n_layers, cfg.n_kv_heads, cfg.hd), np.float32)
    return (ones * 1.25, ones * 0.8) if kv_dtype == "int8" else None


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lut_launch_plan_per_layer(arch, fused, monkeypatch):
    """The LUT launches a layer's step makes: with a SwiGLU MLP 2 multi
    launches (QKV, gate+up) and 2 solo (wo, w_down) fused, 7 solo unfused;
    with the gelu MLP, which has no gate, one multi (QKV) and 3 solo (wo,
    w_up, w_down) fused, 6 solo unfused. The card counts the same per
    kernel (`chip_smoke.py _lut_launches_per_layer`)."""
    model, params = _lcd_port(arch, fused=fused)
    calls = {"multi": [], "solo": 0}
    multi, solo = port_layers.clustered_linear_multi, port_layers.clustered_linear

    def count_multi(x, ws):
        calls["multi"].append(len(ws))
        return multi(x, ws)

    def count_solo(x, w):
        calls["solo"] += 1
        return solo(x, w)
    monkeypatch.setattr(port_layers, "clustered_linear_multi", count_multi)
    monkeypatch.setattr(port_layers, "clustered_linear", count_solo)
    cfg, n_l = model.cfg, model.cfg.n_layers
    cache = port_tf.init_paged_cache(cfg, 8, 4, "float", device="cpu")
    port_tf.paged_decode_step(params, cache, torch.zeros((2, 3), dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32),
                              torch.tensor([3, 1], dtype=torch.int32),
                              torch.arange(8, dtype=torch.int32).view(2, 4), cfg)
    gelu = cfg.mlp == "gelu"
    if fused:
        want_multi = [3] * n_l if gelu else [3, 2] * n_l
        assert calls == {"multi": want_multi, "solo": (3 if gelu else 2) * n_l}
    else:
        assert calls == {"multi": [], "solo": (6 if gelu else 7) * n_l}


@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_vs_solo_tokens_and_fused_vs_unfused(arch, kv_dtype):
    """Staggered requests through the engine: request for request the tokens
    of the same request decoded alone, and the same tokens with fused
    projection groups (QKV; gate+up where the MLP has one) as with
    per-projection launches; every block returned."""
    model, params = _lcd_port(arch)
    ecfg = port_engine.EngineConfig(kv_dtype=kv_dtype, **ECFG)
    smooth = _smooth(model.cfg, kv_dtype)
    prompts = _prompts(model.cfg.vocab, 5, seed=4)
    engine = port_engine.ServingEngine(model, params, ecfg, kv_smooth=smooth, device="cpu")
    requests = _drive(engine, prompts, 6)
    assert set(engine.traces) == {1, 8}
    assert engine.alloc.num_free == ecfg.num_blocks
    tokens = [r.out_tokens for r in requests]
    assert all(len(t) == 6 for t in tokens)
    assert len({tuple(t) for t in tokens}) > 1, "the requests must not all decode alike"
    for r, prompt in zip(requests, prompts):
        solo = port_engine.ServingEngine(model, params, ecfg, kv_smooth=smooth, device="cpu")
        s = solo.submit(prompt, max_new_tokens=6)
        solo.run()
        assert s.out_tokens == r.out_tokens, f"request {r.rid}: engine != solo"
    fused_model, _ = _lcd_port(arch, fused=True)
    fused = port_engine.ServingEngine(fused_model, params, ecfg, kv_smooth=smooth, device="cpu")
    assert [r.out_tokens for r in _drive(fused, prompts, 6)] == tokens, "fused != unfused"


@pytest.mark.parametrize("arch,kv_dtype", [(a, "float") for a in ARCHS]
                         + [("starcoder2-15b", "int8")])
def test_spec_tokens_equal_plain_greedy(arch, kv_dtype):
    """The 2-bit self-draft (made by the port from the 4-bit target) drafts
    k = 3 tokens a round: request for request the plain engine's tokens."""
    model, params = _lcd_port(arch, fused=True)
    draft, _ = port_cp.make_draft_params(params, draft_centroids=4)
    smooth = _smooth(model.cfg, kv_dtype)
    prompts = _prompts(model.cfg.vocab, 4, seed=6)

    def engine(**kw):
        return port_engine.ServingEngine(
            model, params, port_engine.EngineConfig(kv_dtype=kv_dtype, **ECFG, **kw),
            draft_params=draft if kw else None, kv_smooth=smooth, device="cpu")
    plain = _drive(engine(), prompts, 7)
    spec_eng = engine(speculative_k=3)
    spec = _drive(spec_eng, prompts, 7)
    assert set(spec_eng.traces) == {("prefill", 8), ("draft", 3), ("verify", 4)}
    assert [r.out_tokens for r in spec] == [r.out_tokens for r in plain]
    assert spec_eng.alloc.num_free == spec_eng.ecfg.num_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_reference_engine(arch):
    """Same converted LCD params (float transform), same prompts, same
    staggered arrivals: the same greedy tokens and block tables as the
    reference engine, step for step."""
    model, params = _lcd_reference(arch, None)
    kw = dict(num_slots=3, block_size=4, num_blocks=48, max_blocks_per_slot=12,
              prefill_chunk=8)
    ref, _ = ref_engine.build_engine(arch, lcd=True, ecfg=ref_engine.EngineConfig(**kw),
                                     params=params, fused_projections=False)
    port, _ = port_engine.build_engine(arch, lcd=True, ecfg=port_engine.EngineConfig(**kw),
                                       params=_port_tree(params), fused_projections=False,
                                       device="cpu")
    prompts = _prompts(model.cfg.vocab, 5, seed=6)
    pending, reqs_r, reqs_p = list(prompts), [], []
    while pending or ref.busy or port.busy:
        if pending and ref.steps % 2 == 0:
            p = pending.pop(0)
            reqs_r.append(ref.submit(p, max_new_tokens=8))
            reqs_p.append(port.submit(p, max_new_tokens=8))
        if ref.busy:
            ref.step()
            port.step()
            assert_equal(port.block_tables, ref.block_tables, "block tables")
            assert_equal(port.lengths, ref.lengths, "slot lengths")
        else:
            ref.steps += 1
            port.steps += 1
    got, want = [p.out_tokens for p in reqs_p], [r.out_tokens for r in reqs_r]
    assert got == want, (f"{arch}: tokens diverge from the reference's; check its top-2 "
                         f"logit margin at the first difference before calling it a fault")
    assert len({tuple(t) for t in want}) > 1


# continuous mode for every arch (starcoder2-15b's weights LCD-compressed
# first), the static mode for every arch, --speculative for gemma2-27b
CLI = [(a, "continuous") for a in ARCHS] + [(a, "static") for a in ARCHS] + [
    ("gemma2-27b", "speculative")]
FLAGS = {"continuous": ["--continuous", "--requests", "3"], "static": ["--batch", "2"],
         "speculative": ["--continuous", "--speculative", "3", "--requests", "3"]}


@pytest.mark.parametrize("arch,mode", CLI)
def test_serve_cli(arch, mode):
    """`python -m repro_torch.launch.serve --arch <arch> --reduced` in both
    modes and with --speculative, on the CPU."""
    lcd = ["--lcd"] if arch == "starcoder2-15b" else []
    out = port_serve.main(["--arch", arch, "--reduced", "--tokens", "4", "--prompt-len", "10",
                           "--device", "cpu", *FLAGS[mode], *lcd])
    if mode == "static":
        assert tuple(out.shape) == (2, 4)
    else:
        assert len(out) == 3 and all(len(r.out_tokens) == 4 for r in out)
