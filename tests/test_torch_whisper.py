"""The audio family in the port — whisper-large-v3, an encoder-decoder
transformer over precomputed frame embeddings — against the reference on
its `reduced()` config (2 encoder layers, 4 decoder layers, d_model 128,
4 heads padded to 16, enc_seq 32, f32), module by module, on the same numpy
inputs and the same converted params: the parameter table, `encode`,
`decode_full`, the full-sequence forward (`Model.apply` with `frames`),
`build_cross_cache`, the static `decode_step` over a float and an int8
self cache (the int8 one also op by op), `encode_prefill` and the engine's `serving_step` at widths 1
and 8, each dense and with LCD 4-bit weights under the float transform;
the quantized transform op by op; the ragged `layers._attn_chunk`; the
port's forward against its own decode.

Tolerances: configs, tables and int8 cache codes exact (a whole int8 stack
at one decoder layer, deeper ones op by op: see
`test_decode_step_equals_the_reference`); logits, encoder
outputs and state leaves atol 1e-4 + rtol 1e-4 (f32 sums of a few layers
taken in another order: ≤ 3.1e-6 seen); the quantized transform's integers
exact and each projection's output at the LUT kernels' own bound
(`tests/test_torch_lut_matmul.py`): rtol 1e-5 plus 1e-5 · ‖T(x) row‖ ·
max ‖w column‖ · s_q; forward = decode 2e-3 (the reference's
`tests/test_models.py` bound)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import lut_serving
from repro.models import config as ref_config
from repro.models import layers as ref_layers
from repro.models import whisper as ref_whisper
from repro_torch.convert import from_reference
from repro_torch.models import config as port_config
from repro_torch.models import layers as port_layers
from repro_torch.models import whisper as port_whisper
from repro_torch.models.params import iter_table
from repro_torch.models.registry import CAP_ENCODER, PORTED_FAMILIES, get_model
from repro_torch.models.transformer import layer_slice

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (assert_close, assert_equal, np_of, port_model, reference_model,
                  to_numpy_tree)
from test_torch_family import _lively
from test_torch_lut_matmul import _atol
from test_torch_recurrent import cluster_family

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

ARCH = "whisper-large-v3"
TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = ("dense", "lcd_float")


def _port_tree(tree, dtype=None):
    return from_reference(to_numpy_tree(tree), device="cpu", dtype=dtype)


def pair(seed=0, variant="dense", **overrides):
    """(reference model, its params, port model, the port's params) at
    `reduced()`, f32: dense with every bias and norm moved off its initial
    value, or LCD 4-bit (every projection clustered, smoothing vectors in
    [0.5, 1.5], the float transform)."""
    model, params = reference_model(ARCH, seed=seed, **overrides)
    params = _lively(params, seed + 100)
    if variant == "lcd_float":
        params = cluster_family(model, params, 4, smooth_seed=seed + 1, dense=())
    return model, params, port_model(ARCH, **overrides), _port_tree(params)


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)


def _serving(variant):
    return lut_serving("interpret" if variant != "dense" else None)


# ---------------------------------------------------------------------------
# config, table, registry
# ---------------------------------------------------------------------------

def test_config_reduced_config_and_capabilities_equal_the_reference():
    """Every field and derived width of the registered config and of its
    `reduced()` form (2 encoder + 4 decoder layers, 16 padded heads, enc_seq
    32) equals the reference's, and so does the closed-form `param_count`;
    the model has the encoder capability and the family is ported."""
    for make in (lambda m: m.get_config(ARCH), lambda m: m.reduced(m.get_config(ARCH))):
        ref, port = make(ref_config), make(port_config)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for f in ("hd", "padded_vocab", "n_heads_eff", "q_dim_eff", "is_encdec"):
            assert getattr(port, f) == getattr(ref, f), f
        assert port.param_count() == ref.param_count()
    small = port_config.reduced(port_config.get_config(ARCH))
    assert (small.n_enc_layers, small.n_layers, small.n_heads_eff, small.enc_seq) == (
        2, 4, 16, 32)
    model = get_model(ARCH)
    assert CAP_ENCODER in model.capabilities and "audio" in PORTED_FAMILIES
    assert model.seq_caches["slot"].snapshot and "paged" not in model.seq_caches


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_table_equals_the_reference(full):
    """The table's paths, shapes, sharding names, inits and dtypes equal the
    reference's (full width: 1280 -> 2048 projections over 32 padded heads,
    1280 -> 5120 -> 1280 MLPs, the 53248-row tied embedding); the table
    counts the same parameters; `init` draws every leaf at its shape and
    dtype."""
    from repro.models import params as ref_params_mod
    if full:
        rcfg, pcfg = ref_config.get_config(ARCH), port_config.get_config(ARCH)
    else:
        rcfg, pcfg = reference_model(ARCH)[0].cfg, port_model(ARCH).cfg
    rt, pt = ref_whisper.param_table(rcfg), port_whisper.param_table(pcfg)
    ref_decl = {jax.tree_util.keystr(kp): d for kp, d in jax.tree_util.tree_flatten_with_path(
        rt, is_leaf=lambda d: hasattr(d, "names"))[0]}
    port = dict(iter_table(pt))
    assert sorted(port) == sorted(ref_decl)
    for path, d in port.items():
        r = ref_decl[path]
        assert (d.shape, d.names, d.init, d.dtype) == (r.shape, r.names, r.init, r.dtype), path
    assert get_model(pcfg).param_count() == ref_params_mod.param_count(rt)
    if full:
        assert port["['dec']['blocks']['self_attn']['wq']"].shape == (32, 1280, 2048)
        assert port["['enc']['blocks']['mlp']['w_down']"].shape == (32, 5120, 1280)
        return
    params = get_model(pcfg).init(torch.Generator().manual_seed(0), device="cpu")
    flat = {jax.tree_util.keystr(kp): v for kp, v in jax.tree_util.tree_flatten_with_path(
        params)[0]}
    for path, d in port.items():
        assert tuple(flat[path].shape) == d.shape and flat[path].dtype == (
            torch.float32), path


def test_sinusoid_equals_the_reference():
    assert_equal(port_whisper._sinusoid(1500, 1280), ref_whisper._sinusoid(1500, 1280),
                 "sinusoid")


# ---------------------------------------------------------------------------
# the ragged attention chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ragged_attn_chunk_equals_the_reference(causal):
    """`layers._attn_chunk` with per-row positions (B, Cq) and a per-row key
    count `k_len` (the serving step's self-attention) and without `k_len`
    (its cross-attention), against the reference's on the same inputs; a
    row whose keys are all masked returns zeros in both."""
    rng = np.random.default_rng(3 + causal)
    b, cq, h, sk, d = 3, 4, 8, 12, 16
    q = rng.normal(size=(b, cq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    lengths = np.array([0, 5, 8], np.int32)
    q_pos = (lengths[:, None] + np.arange(cq)[None]).astype(np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    for k_len in (lengths + np.array([0, 3, 2], np.int32), None):
        kw = dict(causal=causal, window=0, softcap=0.0, scale=0.25)
        want = ref_layers._attn_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(q_pos), jnp.asarray(k_pos), **kw,
                                      k_len=None if k_len is None else jnp.asarray(k_len))
        got = port_layers._attn_chunk(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(q_pos), torch.from_numpy(k_pos), **kw,
            k_len=None if k_len is None else torch.from_numpy(k_len))
        assert_close(np_of(got), np.asarray(want), rtol=1e-5, atol=1e-6,
                     what=f"causal={causal} k_len={k_len}")
        if k_len is not None and causal:
            assert not np_of(got)[0].any()          # slot 0: no valid key


@pytest.mark.parametrize("cq", [1, 4, 40])
def test_ragged_attention_equals_the_reference_chunk(cq):
    """`layers.ragged_attention` (the serving step's attention: `_attn_chunk`
    over blocks of exactly 32 query rows, the last padded and sliced away)
    against the reference's `_attn_chunk` over the whole window (1 row, 4
    rows, 40 rows = two blocks), self (causal, `k_len`) and cross; and a
    decoding slot's row gets the same bits alone at width 1 as at the head
    of a 32-row window."""
    rng = np.random.default_rng(cq)
    b, h, sk, d = 3, 8, 64, 16
    q = rng.normal(size=(b, cq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    lengths = np.array([0, 5, 20], np.int32)
    q_pos = (lengths[:, None] + np.arange(cq)[None]).astype(np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    k_len = (lengths + np.minimum(cq, np.array([cq, 1, 3]))).astype(np.int32)
    t = {n: torch.from_numpy(a) for n, a in dict(q=q, k=k, v=v, q_pos=q_pos, k_pos=k_pos,
                                                 k_len=k_len).items()}
    for causal, kl in ((True, "k_len"), (False, None)):
        want = ref_layers._attn_chunk(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
            jnp.asarray(k_pos), causal=causal, window=0, softcap=0.0, scale=0.25,
            k_len=None if kl is None else jnp.asarray(k_len))
        got = port_layers.ragged_attention(t["q"], t["k"], t["v"], t["q_pos"], t["k_pos"],
                                           causal=causal, scale=0.25,
                                           k_len=None if kl is None else t["k_len"])
        assert got.shape == (b, cq, h, d)
        assert_close(np_of(got), np.asarray(want), rtol=1e-5, atol=1e-6,
                     what=f"cq={cq} causal={causal}")
    q32 = torch.from_numpy(rng.normal(size=(b, 32, h, d)).astype(np.float32))
    q32[:, :1] = t["q"][:, :1]
    pos32 = torch.from_numpy(lengths)[:, None] + torch.arange(32, dtype=torch.int32)[None]
    one = torch.from_numpy(lengths + 1)
    for kw in (dict(causal=True, k_len=one), dict(causal=False)):
        alone = port_layers.ragged_attention(t["q"][:, :1], t["k"], t["v"], pos32[:, :1],
                                             t["k_pos"], scale=0.25, **kw)
        head = port_layers.ragged_attention(q32, t["k"], t["v"], pos32, t["k_pos"],
                                            scale=0.25, **kw)[:, :1]
        assert torch.equal(alone, head), kw


# ---------------------------------------------------------------------------
# the encoder, the decoder and the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_encode_and_cross_cache_equal_the_reference(variant):
    """`encode` (frames of 2 requests + the sinusoid, 2 layers of bidirectional
    attention and gelu MLP, the final layernorm), `build_cross_cache` (two
    projections per decoder layer, stacked (L, B, enc_seq, H, D)) and
    `encode_prefill` (one request's (L, enc_seq, H, D))."""
    model, params, pmodel, pp = pair(seed=1, variant=variant)
    cfg = model.cfg
    frames = _frames(cfg, 2, 2)
    with _serving(variant):
        want = ref_whisper.encode(params, jnp.asarray(frames), cfg)
        want_k, want_v = ref_whisper.build_cross_cache(params, want, cfg)
        pre_k, pre_v = model.encode_prefill(params, jnp.asarray(frames[1:]))
    with torch.no_grad():
        got = port_whisper.encode(pp, torch.from_numpy(frames), pmodel.cfg)
        got_k, got_v = port_whisper.build_cross_cache(pp, got, pmodel.cfg)
    got_pk, got_pv = pmodel.encode_prefill(pp, torch.from_numpy(frames[1:]))
    assert_close(np_of(got), np.asarray(want), **TOL, what=f"{variant} encode")
    assert tuple(got_k.shape) == (4, 2, 32, 16, 32)
    for g, w, what in ((got_k, want_k, "ck"), (got_v, want_v, "cv"),
                       (got_pk, pre_k, "prefill ck"), (got_pv, pre_v, "prefill cv")):
        assert_close(np_of(g), np.asarray(w), **TOL, what=f"{variant} {what}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_full_and_forward_equal_the_reference(variant):
    """`decode_full` on the reference's own encoder output (causal self-
    attention, cross-attention, the tied head) and `Model.apply` with
    `frames` (the whole forward), 2 sequences of 9 tokens."""
    model, params, pmodel, pp = pair(seed=3, variant=variant)
    cfg = model.cfg
    frames = _frames(cfg, 2, 4)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    with _serving(variant):
        enc = ref_whisper.encode(params, jnp.asarray(frames), cfg)
        want_dec, _ = ref_whisper.decode_full(params, jnp.asarray(tokens), enc, cfg)
        want, _ = model.apply(params, {"tokens": jnp.asarray(tokens),
                                       "frames": jnp.asarray(frames)})
    with torch.no_grad():
        got_dec, aux = port_whisper.decode_full(pp, torch.from_numpy(tokens),
                                                torch.from_numpy(np.array(enc)), pmodel.cfg)
        got, _ = pmodel.apply(pp, {"tokens": torch.from_numpy(tokens),
                                   "frames": torch.from_numpy(frames)})
    assert float(aux) == 0.0 and tuple(got.shape) == (2, 9, cfg.padded_vocab)
    assert_close(np_of(got_dec), np.asarray(want_dec), **TOL, what=f"{variant} decode_full")
    assert_close(np_of(got), np.asarray(want), **TOL, what=f"{variant} forward")


def test_remat_changes_no_number_and_the_forward_is_differentiable():
    """With `cfg.remat` (each layer of both stacks under
    `torch.utils.checkpoint`) and without, the forward's logits and the
    gradients of a loss through it are the same; gradients reach the
    encoder's first layer."""
    _, _, pmodel, pp = pair(seed=6)
    cfg = pmodel.cfg
    frames = torch.from_numpy(_frames(cfg, 1, 7))
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (1, 6)))
    outs = []
    for remat in (True, False):
        m = get_model(dataclasses.replace(cfg, remat=remat))
        w = pp["enc"]["blocks"]["attn"]["wq"].clone().requires_grad_(True)
        p = {**pp, "enc": {**pp["enc"], "blocks": {**pp["enc"]["blocks"], "attn": {
            **pp["enc"]["blocks"]["attn"], "wq": w}}}}
        logits, _ = m.apply(p, {"tokens": tokens, "frames": frames})
        (g,) = torch.autograd.grad(logits.square().mean(), w)
        outs.append((logits.detach(), g))
    assert torch.equal(outs[0][0], outs[1][0])
    assert_close(np_of(outs[0][1]), np_of(outs[1][1]), rtol=1e-6, atol=1e-9, what="grad")
    assert float(outs[0][1][0].abs().max()) > 0


# ---------------------------------------------------------------------------
# the static decode path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_step_equals_the_reference(variant, kv):
    """The static path over a cache whose cross K/V come from
    `build_cross_cache`: a 6-token prompt in one call, then three one-token
    steps (explicit positions, as the reference's callers pass them): the
    last token's logits and every cache leaf after each call. Over the int8
    self cache the codes are exact at one decoder layer: from the second on,
    an f32 difference of an ulp upstream puts an element on the other side
    of a rounding boundary now and then (1 code in 8192 at 2 layers), and
    each such code moves the next layers' K / V by a step of their scale,
    so codes cascade (115 at 4 layers). Deeper int8 stacks are held op by
    op (`test_int8_self_cache_attention_op_by_op`)."""
    over = {"kv_cache_dtype": "int8", "n_layers": 1} if kv == "int8" else {}
    model, params, pmodel, pp = pair(seed=9, variant=variant, **over)
    cfg = model.cfg
    frames = _frames(cfg, 2, 10)
    with _serving(variant):
        ck, cv = ref_whisper.build_cross_cache(
            params, ref_whisper.encode(params, jnp.asarray(frames), cfg), cfg)
    cache = dict(model.init_cache(2, 16), ck=ck, cv=cv)
    pcache = _port_tree(cache)
    assert pcache["k"].dtype == (torch.int8 if kv == "int8" else torch.float32)
    rng = np.random.default_rng(11)
    ref_dec = jax.jit(model.decode)
    pos = 0
    for i, s in enumerate((6, 1, 1, 1)):
        tokens = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
        with _serving(variant):
            want, cache = ref_dec(params, cache, {"tokens": jnp.asarray(tokens),
                                                  "pos": jnp.asarray(pos, jnp.int32)})
        got, pcache = pmodel.decode(pp, pcache, {"tokens": torch.from_numpy(tokens),
                                                 "pos": pos})
        what = f"{variant}/{kv} call {i}"
        assert_close(np_of(got), np.asarray(want), **TOL, what=f"{what} logits")
        for name, w in cache.items():
            g = np_of(pcache[name])
            if name == "pos" or w.dtype == jnp.int8:
                assert_equal(g, np.asarray(w), f"{what}: {name}")
            else:
                assert_close(g, np.asarray(w), **TOL, what=f"{what}: {name}")
        pos += s


def test_int8_self_cache_attention_op_by_op():
    """The decoder's self-attention over the int8 static cache (`_mha`: absmax
    codes per (token, head), dequantized on read), every layer of the
    4-layer stack on the same inputs and the same cache state: a 6-token
    prompt, then three one-token calls, each package carrying its own
    cache: the codes exact, the scales and the outputs within 1e-4 + 1e-4."""
    model, params, pmodel, pp = pair(seed=20, kv_cache_dtype="int8")
    cfg = model.cfg
    rng = np.random.default_rng(21)
    cache = model.init_cache(2, 16)
    pcache = _port_tree(cache)
    for l in range(cfg.n_layers):
        ref_p = jax.tree_util.tree_map(lambda a: a[l], params["dec"]["blocks"]["self_attn"])
        port_p = layer_slice(pp["dec"]["blocks"]["self_attn"], l)
        names = ("k", "v", "k_scale", "v_scale")
        lc = {n: cache[n][l] for n in names}
        plc = {n: pcache[n][l] for n in names}
        pos = 0
        for s in (6, 1, 1, 1):
            x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
            want, lc = ref_whisper._mha(ref_p, jnp.asarray(x), cfg, causal=True,
                                        cache={**lc, "pos": jnp.int32(pos)})
            got, _ = port_whisper._mha(port_p, torch.from_numpy(x), pmodel.cfg, causal=True,
                                       cache={**plc, "pos": pos})
            what = f"layer {l} at {pos}"
            assert_close(np_of(got), np.asarray(want), **TOL, what=f"{what} out")
            for n in names:
                if n in ("k", "v"):
                    assert_equal(np_of(plc[n]), np.asarray(lc[n]), f"{what}: {n} codes")
                else:
                    assert_close(np_of(plc[n]), np.asarray(lc[n]), **TOL, what=f"{what}: {n}")
            pos += s
        assert int((np_of(plc["k"]) != 0).sum()) > 0


def test_forward_equals_decode_within_the_reference_bound():
    """The full-sequence forward against token-by-token `decode_step` over
    the cross K/V of the same frames, in the port, within the reference's
    own 2e-3 (`tests/test_models.py::test_decode_matches_forward`)."""
    pmodel = port_model(ARCH)
    cfg = pmodel.cfg
    params = pmodel.init(torch.Generator().manual_seed(0), device="cpu")
    frames = torch.from_numpy(_frames(cfg, 2, 12))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        logits, _ = pmodel.apply(params, {"tokens": tokens, "frames": frames})
        ck, cv = port_whisper.build_cross_cache(
            params, port_whisper.encode(params, frames, cfg), cfg)
    cache = pmodel.init_cache(2, 16, device="cpu")
    cache["ck"].copy_(ck)
    cache["cv"].copy_(cv)
    errs = []
    for i in range(8):
        lg, cache = pmodel.decode(params, cache, {"tokens": tokens[:, i:i + 1],
                                                  "pos": cache["pos"]})
        errs.append(float((lg - logits[:, i]).abs().max()))
    assert int(cache["pos"]) == 8 and max(errs) < 2e-3, errs


# ---------------------------------------------------------------------------
# the engine's step
# ---------------------------------------------------------------------------

def _steps(cfg, s_slots, t, rng):
    """A width-t step with ragged n_new (slot 1 idle), a second that
    finishes the prompts, then two width-1 decode steps."""
    n_first = np.array([t, 0, t - 3, 2][:s_slots], np.int32)
    steps = [(rng.integers(0, cfg.vocab, (s_slots, t)).astype(np.int32), n_first),
             (rng.integers(0, cfg.vocab, (s_slots, t)).astype(np.int32),
              np.where(n_first > 0, t - 1, 0).astype(np.int32))]
    for _ in range(2):
        steps.append((rng.integers(0, cfg.vocab, (s_slots, 1)).astype(np.int32),
                      (n_first > 0).astype(np.int32)))
    return steps


@pytest.mark.parametrize("width", [1, 8])
@pytest.mark.parametrize("variant", VARIANTS)
def test_serving_step_equals_the_reference(variant, width):
    """The engine's step (`Model.serving_step`) on the same converted params
    and slot state as the reference's: `encode_prefill` written into the
    live slots' cross K/V (as admission does), then two width-`width` steps
    (ragged n_new; at width 1 every token its own step) and two decode
    steps: the live slots' logits and every state leaf after each step; the
    idle slot's rows stay zero in both."""
    model, params, pmodel, pp = pair(seed=13, variant=variant)
    cfg = model.cfg
    rng = np.random.default_rng(14)
    S, T, max_seq = 4, 8, 24
    caches = model.init_seq_caches(num_blocks=4, block_size=4, num_slots=S, max_seq=max_seq)
    pcaches = _port_tree(caches)
    frames = _frames(cfg, S, 15)
    live = np.array([True, False, True, True])
    for s in np.flatnonzero(live):
        with _serving(variant):
            ck, cv = model.encode_prefill(params, jnp.asarray(frames[s:s + 1]))
        caches["slot"]["ck"] = caches["slot"]["ck"].at[:, s].set(ck)
        caches["slot"]["cv"] = caches["slot"]["cv"].at[:, s].set(cv)
        pck, pcv = pmodel.encode_prefill(pp, torch.from_numpy(frames[s:s + 1]))
        pcaches["slot"]["ck"][:, s].copy_(pck)
        pcaches["slot"]["cv"][:, s].copy_(pcv)
    steps = _steps(cfg, S, T, rng)
    if width == 1:                  # the same tokens, one position a step
        steps = [(tok[:, j:j + 1], (n > j).astype(np.int32)) for tok, n in steps[:2]
                 for j in range(T)] + steps[2:]
    ref_step = jax.jit(model.serving_step)
    lengths = np.zeros(S, np.int32)
    tables = np.zeros((S, 6), np.int32)
    for i, (tokens, n_new) in enumerate(steps):
        args = (tokens, lengths, n_new, tables)
        with _serving(variant):
            want, caches = ref_step(params, caches, *[jnp.asarray(a) for a in args])
        got, out = pmodel.serving_step(pp, pcaches, *[torch.from_numpy(a) for a in args])
        assert out is pcaches and tuple(got.shape) == (S, cfg.padded_vocab)
        what = f"{variant} width {width} step {i}"
        on = live & (n_new > 0)
        assert_close(np_of(got)[on], np.asarray(want)[on], **TOL, what=f"{what} logits")
        for name, w in caches["slot"].items():
            assert_close(np_of(pcaches["slot"][name]), np.asarray(w), **TOL,
                         what=f"{what}: {name}")
        lengths = lengths + n_new
    for name, t in pcaches["slot"].items():
        assert not t[:, 1].any(), f"idle slot 1: {name} was written"
    assert int(lengths[0]) == 2 * T - 1 + 2


def test_quantized_transform_op_by_op():
    """LCD 4-bit weights with the quantized Eq. 11 transform (s_q 0.06), op
    by op: every clustered projection of layer 0 of both stacks (the
    encoder's q/k/v/o and MLP, the decoder's self- and cross-attention and
    MLP; 16 tensors) on the same inputs through the reference's
    `layers.linear` (Pallas, interpret mode) and the port's: the transform's
    integers exact, the outputs at the LUT kernels' own bound. Whole-model
    comparisons stay with the float transform: the quantizer is
    discontinuous, so an ulp there is another integer."""
    model, params = reference_model(ARCH, seed=16)
    params = cluster_family(model, params, 4, act_scale=0.06, smooth_seed=17, dense=())
    pp = _port_tree(params)
    rng = np.random.default_rng(18)
    paths = [("enc", "attn", n) for n in ("wq", "wk", "wv", "wo")] + [
        ("enc", "mlp", n) for n in ("w_up", "w_down")] + [
        ("dec", blk, n) for blk in ("self_attn", "cross_attn") for n in ("wq", "wk", "wv",
                                                                         "wo")] + [
        ("dec", "mlp", n) for n in ("w_up", "w_down")]
    assert len(paths) == 16
    for stack, blk, name in paths:
        ref_w = jax.tree_util.tree_map(lambda a: a[0],
                                       params[stack]["blocks"][blk][name])
        port_w = layer_slice(pp[stack]["blocks"][blk][name], 0)
        d_in = port_w.smooth.shape[-1]
        x = rng.normal(size=(2, 5, d_in)).astype(np.float32)
        with lut_serving("interpret"):
            want = np.asarray(ref_layers.linear(jnp.asarray(x), ref_w))
        got = np_of(port_layers.linear(torch.from_numpy(x), port_w))
        inv = np.asarray(ref_w.inv_scale)
        q_ref = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * inv), -127, 127))
        q_port = torch.clamp(torch.round(torch.from_numpy(x) * port_w.inv_scale), -127, 127)
        assert_equal(np_of(q_port), q_ref, f"{stack}/{blk}/{name}: Eq. 11 integers")
        codes = np.asarray(ref_w.codes).astype(np.int64)
        atol = (_atol(x.reshape(-1, d_in), inv, codes, np.asarray(ref_w.codebook), True)
                * 0.06).reshape(2, 5, 1)
        assert_close(got, want, rtol=1e-5, atol=atol, what=f"{stack}/{blk}/{name}")


def test_convert_keeps_the_norms_f32_in_a_bf16_model():
    """`from_reference(..., dtype=bfloat16)` casts the projections, biases,
    embeddings and the slot state (self and cross K/V) to bf16 and keeps the
    layernorms' scales and biases f32, as the port's own init does."""
    model, params = reference_model(ARCH, seed=19, dtype="bfloat16")
    pmodel = port_model(ARCH, dtype="bfloat16")
    pp = _port_tree(params, dtype=torch.bfloat16)
    want = pmodel.init(torch.Generator().manual_seed(0), device="cpu")
    got_l = jax.tree_util.tree_flatten_with_path(pp)[0]
    want_l = dict((jax.tree_util.keystr(k), v) for k, v in
                  jax.tree_util.tree_flatten_with_path(want)[0])
    for kp, g in got_l:
        assert g.dtype == want_l[jax.tree_util.keystr(kp)].dtype, jax.tree_util.keystr(kp)
    assert pp["enc"]["ln_final"]["bias"].dtype == torch.float32
    assert pp["dec"]["blocks"]["mlp"]["b_up"].dtype == torch.bfloat16
    state = _port_tree(model.init_seq_caches(num_blocks=2, block_size=4, num_slots=2,
                                             max_seq=8), dtype=torch.bfloat16)["slot"]
    want_s = pmodel.init_seq_caches(num_blocks=2, block_size=4, num_slots=2, max_seq=8,
                                    device="cpu")["slot"]
    for name, t in want_s.items():
        assert state[name].dtype == t.dtype == torch.bfloat16, name
        assert tuple(state[name].shape) == tuple(t.shape), name
