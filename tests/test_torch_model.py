"""The port's model modules against the reference on `reduced()` configs:
rmsnorm, rope, mlp_block, paged_attn_block one by one, then whole
`paged_decode_step` runs (a prefill chunk and several decode steps) on
converted params — dense, LCD with the float transform, LCD with the quantized
Eq. 11 transform — on float and int8 pools, the pools compared too.

The reference runs on the CPU: its Pallas kernels in interpret mode for the LCD
runs (`lut_serving("interpret")`, the only mode that applies the quantized
transform), its jnp paths otherwise. Tolerances: logits atol 2e-4, float pools
1e-5, int8 KV codes exact, scales 1e-6."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import lut_serving
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.convert import from_reference
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_tf

from _xfw import (assert_close, assert_equal, both, cluster_params, np_of,
                  port_model, reference_model, to_numpy_tree)

pytestmark = pytest.mark.tier1

ARCHS = ("llama2-7b", "qwen2-1.5b")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_rmsnorm_uses_one_plus_scale():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=64).astype(np.float32) * 0.1
    want, got = both(ref_layers.rmsnorm, port_layers.rmsnorm, x, scale)
    assert_close(got, want, rtol=1e-6, atol=1e-6, what="rmsnorm")
    zero = np.zeros(64, np.float32)
    _, unit = both(ref_layers.rmsnorm, port_layers.rmsnorm, x, zero)
    assert_close((unit ** 2).mean(-1), np.ones((3, 5)), atol=1e-4, what="scale 0 -> unit rms")


def test_layernorm_and_norm_dispatch():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 32)).astype(np.float32)
    scale, bias = rng.normal(size=(2, 32)).astype(np.float32)
    want, got = both(ref_layers.layernorm, port_layers.layernorm, x, scale, bias)
    assert_close(got, want, rtol=1e-5, atol=1e-5, what="layernorm")
    for kind in ("rmsnorm", "layernorm"):
        w = np.asarray(ref_layers.norm(jnp.asarray(x), {"scale": scale, "bias": bias}, kind))
        g = np_of(port_layers.norm(torch.from_numpy(x), {"scale": torch.from_numpy(scale),
                                                         "bias": torch.from_numpy(bias)}, kind))
        assert_close(g, w, rtol=1e-5, atol=1e-5, what=f"norm[{kind}]")


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 6, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 500, (3, 6)).astype(np.int32)
    want, got = both(ref_layers.rope, port_layers.rope, x, pos,
                     ref_kwargs=dict(theta=theta), port_kwargs=dict(theta=theta))
    assert_close(got, want, rtol=1e-5, atol=2e-5, what="rope f32")
    # the rotation runs in the activation dtype: bf16 in, bf16 out
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = port_layers.rope(xb, torch.from_numpy(pos), theta)
    assert out.dtype == torch.bfloat16
    wantb = ref_layers.rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos), theta)
    assert_close(np_of(out), np_of(wantb), atol=2 ** -6, rtol=2 ** -7, what="rope bf16")


def _port_tree(tree, dtype=None):
    return from_reference(to_numpy_tree(tree), device="cpu", dtype=dtype)


@pytest.mark.parametrize("lcd", [False, True], ids=["dense", "lcd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_block(arch, lcd):
    model, params = reference_model(arch, n_layers=1)
    if lcd:
        params = cluster_params(params, 4, smooth_seed=3)
    p_ref = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["mlp"])
    p_port = port_tf.layer_slice(_port_tree(params["blocks"]["mlp"]), 0)
    x = np.random.default_rng(4).normal(size=(2, 3, 128)).astype(np.float32)
    with lut_serving("interpret" if lcd else None):
        want = np.asarray(ref_layers.mlp_block(p_ref, jnp.asarray(x), model.cfg))
    got = np_of(port_layers.mlp_block(p_port, torch.from_numpy(x), port_model(arch).cfg))
    assert_close(got, want, rtol=1e-4, atol=2e-5, what="mlp_block")


@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_attn_block(arch, kv_dtype):
    model, params = reference_model(arch, n_layers=1)
    cfg = model.cfg
    rng = np.random.default_rng(5)
    attn = dict(params["blocks"]["attn"])
    for b in ("bq", "bk", "bv"):
        if b in attn:                                   # zero-initialised: make them count
            attn[b] = jnp.asarray(rng.normal(size=attn[b].shape).astype(np.float32) * 0.1)
    p_ref = jax.tree_util.tree_map(lambda a: a[0], attn)
    p_port = port_tf.layer_slice(_port_tree(attn), 0)
    S, T, nb, bs, nbw = 3, 4, 12, 4, 4
    cache = ref_tf.init_paged_cache(cfg, nb, bs, kv_dtype)
    if kv_dtype == "int8":
        cache["k_smooth"] = jnp.asarray(rng.uniform(0.5, 2, cache["k_smooth"].shape), jnp.float32)
        cache["v_smooth"] = jnp.asarray(rng.uniform(0.5, 2, cache["v_smooth"].shape), jnp.float32)
    # pre-existing cache content that the step must leave alone where it does not write
    cache["k"] = jnp.asarray(rng.integers(-50, 50, cache["k"].shape), cache["k"].dtype)
    cache["v"] = jnp.asarray(rng.integers(-50, 50, cache["v"].shape), cache["v"].dtype)
    x = rng.normal(size=(S, T, cfg.d_model)).astype(np.float32)
    tables = rng.permutation(nb)[:S * nbw].reshape(S, nbw).astype(np.int32)
    lengths = np.array([5, 0, 2], np.int32)
    n_new = np.array([T, 0, 2], np.int32)               # full chunk, idle slot, short chunk
    names = {"k": "kc", "v": "vc", "k_scale": "kc_scale", "v_scale": "vc_scale",
             "k_smooth": "k_smooth", "v_smooth": "v_smooth"}
    ref_kw = {names[k]: v[0] for k, v in cache.items()}
    out_ref, *pools_ref = ref_layers.paged_attn_block(
        p_ref, jnp.asarray(x), cfg, layer_window=0, block_tables=jnp.asarray(tables),
        lengths=jnp.asarray(lengths), n_new=jnp.asarray(n_new), **ref_kw)
    pcache = _port_tree(cache)
    port_kw = {names[k]: v[0] for k, v in pcache.items()}
    out_port = port_layers.paged_attn_block(
        p_port, torch.from_numpy(x), port_model(arch).cfg, layer_window=0,
        block_tables=torch.from_numpy(tables), lengths=torch.from_numpy(lengths),
        n_new=torch.from_numpy(n_new), **port_kw)
    live = n_new > 0        # an idle slot's output row is never read
    assert_close(np_of(out_port)[live], np.asarray(out_ref)[live], rtol=1e-4, atol=2e-5,
                 what="paged_attn_block output")
    # pools: updated IN PLACE by the port, returned as new arrays by the reference
    order = ("kc", "vc", "kc_scale", "vc_scale")[:len(pools_ref)]
    for name, want in zip(order, pools_ref):
        got = np_of(port_kw[name])
        if want.dtype == jnp.int8:
            assert_equal(got, np.asarray(want), f"{name} (int8 codes)")
        else:
            assert_close(got, np.asarray(want), rtol=1e-6, atol=1e-5, what=name)


@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_resolve_weight(nbits):
    _, params = reference_model("llama2-7b", n_layers=1)
    ct = cluster_params(params, nbits, smooth_seed=7)["blocks"]["mlp"]["w_up"]
    ref_leaf = jax.tree_util.tree_map(lambda a: a[0], ct)
    port_leaf = port_tf.layer_slice(_port_tree({"w": ct}), 0)["w"]
    want = np.asarray(ref_layers.resolve_weight(ref_leaf, jnp.float32))
    got = np_of(port_layers.resolve_weight(port_leaf, torch.float32))
    assert_close(got, want, rtol=1e-6, atol=1e-7, what="resolve_weight (clustered)")
    dense = np.asarray(params["blocks"]["mlp"]["w_up"][0])
    assert_equal(np_of(port_layers.resolve_weight(torch.from_numpy(dense.copy()), torch.float32)),
                 dense, "resolve_weight (dense)")


def test_scatter_rows_writes_nothing_for_padded_tokens():
    pool = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 3).clone()
    before = pool.clone()
    idx = torch.tensor([1, 1, 6, 0])
    vals = -torch.ones(4, 3) * torch.arange(1, 5)[:, None]
    port_layers._scatter_rows(pool, idx, vals, torch.tensor([False, True, True, False]))
    want = before.clone().view(8, 3)
    want[1], want[6] = vals[1], vals[2]
    assert torch.equal(pool.view(8, 3), want)
    port_layers._scatter_rows(pool, idx, vals, torch.zeros(4, dtype=torch.bool))
    assert torch.equal(pool.view(8, 3), want), "no valid token: nothing may change"


# ---------------------------------------------------------------------------
# whole paged_decode_step runs
# ---------------------------------------------------------------------------

def _steps(cfg, S, T, rng):
    n_first = np.array([T, 0, T - 3, 2][:S], np.int32)       # slot 1 idle throughout
    steps = [(rng.integers(0, cfg.vocab, (S, T)).astype(np.int32), n_first)]
    for _ in range(3):
        steps.append((rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32),
                      (n_first > 0).astype(np.int32)))
    return steps


VARIANTS = {"dense": None, "lcd_float": dict(act_scale=None), "lcd_quant": dict(act_scale=0.06)}


@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_logits_and_pools(arch, variant, kv_dtype):
    model, params = reference_model(arch, seed=1, n_layers=2)
    cfg = model.cfg
    rng = np.random.default_rng(17)
    if cfg.qkv_bias:
        attn = dict(params["blocks"]["attn"])
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(rng.normal(size=attn[b].shape).astype(np.float32) * 0.1)
        params = {**params, "blocks": {**params["blocks"], "attn": attn}}
    if VARIANTS[variant] is not None:
        params = cluster_params(params, 4, smooth_seed=2, **VARIANTS[variant])
    S, T, nb, bs, nbw = 4, 8, 16, 4, 4
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
        assert_close(np_of(got)[live], np.asarray(want)[live], atol=2e-4,
                     what=f"{arch}/{variant}/{kv_dtype} logits, step {i}")
        lengths = lengths + n_new
    for name, want in cache.items():
        got = np_of(pcache[name])
        if want.dtype == jnp.int8:
            assert_equal(got, np.asarray(want), f"{name} pool (int8 codes)")
        else:
            assert_close(got, np.asarray(want), rtol=1e-6,
                         atol=1e-6 if "scale" in name else 1e-5, what=f"{name} pool")


GEMMA_LIKE = dict(layer_pattern="alt_local_global", local_window=6, attn_softcap=20.0,
                  final_softcap=10.0, tie_embeddings=True, mlp="gelu", norm="layernorm")


def test_paged_decode_step_with_windows_softcaps_tied_head_gelu_layernorm():
    """The config switches llama2-7b and qwen2-1.5b leave off: alternating
    local/global windows (a Python int per layer in the port), attention and
    final softcaps, a tied vocab head, the gelu MLP with biases, layernorm."""
    model, params = reference_model("llama2-7b", seed=3, n_layers=2, **GEMMA_LIKE)
    cfg = model.cfg
    rng = np.random.default_rng(23)
    mlp = dict(params["blocks"]["mlp"])
    for b in ("b_up", "b_down"):
        mlp[b] = jnp.asarray(rng.normal(size=mlp[b].shape).astype(np.float32) * 0.1)
    params = {**params, "blocks": {**params["blocks"], "mlp": mlp}}
    assert "lm_head" not in params
    S, T, nb, bs, nbw = 3, 8, 24, 4, 8
    cache = ref_tf.init_paged_cache(cfg, nb, bs, "float")
    tables = rng.permutation(nb).reshape(S, nbw).astype(np.int32)
    pcfg = port_model("llama2-7b", n_layers=2, **GEMMA_LIKE).cfg
    assert list(port_tf.layer_windows(pcfg)) == [6, 0]
    pparams, pcache = _port_tree(params), _port_tree(cache)
    ref_step = jax.jit(functools.partial(ref_tf.paged_decode_step, cfg=cfg))
    lengths = np.zeros(S, np.int32)
    n_first = np.array([T, T - 2, 3], np.int32)
    steps = [(rng.integers(0, cfg.vocab, (S, T)).astype(np.int32), n_first)]
    steps += [(rng.integers(0, cfg.vocab, (S, T)).astype(np.int32), np.full(S, T, np.int32))]
    steps += [(rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32), np.ones(S, np.int32))] * 2
    for i, (tokens, n_new) in enumerate(steps):
        want, cache = ref_step(params, cache, jnp.asarray(tokens), jnp.asarray(lengths),
                               jnp.asarray(n_new), jnp.asarray(tables))
        got, pcache = port_tf.paged_decode_step(
            pparams, pcache, torch.from_numpy(tokens), torch.from_numpy(lengths),
            torch.from_numpy(n_new), torch.from_numpy(tables), pcfg)
        assert float(np.abs(np.asarray(want)).max()) <= 10.0       # the final softcap
        assert_close(np_of(got), np.asarray(want), atol=2e-4, what=f"logits, step {i}")
        lengths = lengths + n_new
    for name in ("k", "v"):
        assert_close(np_of(pcache[name]), np.asarray(cache[name]), rtol=1e-6, atol=1e-5,
                     what=f"{name} pool")


def test_tables_windows_and_cache_layout_match_reference():
    for arch in ARCHS:
        model, _ = reference_model(arch)
        pm = port_model(arch)
        assert pm.param_count() == model.param_count()
        from repro_torch.models.params import iter_table
        ref_paths = [jax.tree_util.keystr(kp) for kp, _ in jax.tree_util.tree_flatten_with_path(
            model.table, is_leaf=lambda d: hasattr(d, "names"))[0]]
        port = dict(iter_table(pm.table))
        assert sorted(port) == sorted(ref_paths)
        ref_decl = {jax.tree_util.keystr(kp): d for kp, d in jax.tree_util.tree_flatten_with_path(
            model.table, is_leaf=lambda d: hasattr(d, "names"))[0]}
        for path, d in port.items():
            r = ref_decl[path]
            assert (d.shape, d.names, d.init, d.dtype) == (r.shape, r.names, r.init, r.dtype)
        assert_equal(port_tf.layer_windows(pm.cfg), ref_tf.layer_windows(model.cfg), "windows")
        for kv in ("float", "int8"):
            rc = ref_tf.init_paged_cache(model.cfg, 6, 4, kv)
            pc = port_tf.init_paged_cache(pm.cfg, 6, 4, kv, device="cpu")
            assert sorted(rc) == sorted(pc)
            for k in rc:
                assert_equal(np_of(pc[k]), np.asarray(rc[k]), f"fresh {kv} cache {k}")
        for f in ("hd", "padded_vocab", "n_heads_eff", "q_dim_eff", "kv_dim"):
            assert getattr(pm.cfg, f) == getattr(model.cfg, f), f
