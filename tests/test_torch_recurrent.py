"""The recurrent and hybrid families in the port — rwkv6-1.6b (WKV6 with a
data-dependent decay), gla-1.3b (gated linear attention) and zamba2-1.2b
(a Mamba2 backbone with one shared attention block) — against the reference
on `reduced()` configs: configs and parameter tables, the three chunked
forms of `linear_attn.py` (against the reference's and against the port's
own sequential scans), and per arch × (dense, LCD with the float transform,
LCD with the quantized transform) the full-sequence forward, the static
`decode_step` and the engine's `serving_step` (logits and every state leaf,
zamba2's pools too); forward = decode; one training step of rwkv6; and the
two reference properties the port reproduces (gla's clustered gate LoRA and
zamba2's clustered `d_skip` raise in both packages). The engine is in
`tests/test_torch_recurrent_engine.py`.

LCD weights are `cluster_family`'s: every leaf the reference's
`materialize_clustered` clusters, quantile-clustered, except gla's
`gate_A` / `gate_B`, which stay dense (LCD gla with a clustered gate LoRA
cannot run in the reference).

Tolerances: configs, tables and codes exact; chunked forms against the
reference's rtol 1e-5 atol 1e-5 (f32 sums of exponentials in other orders;
1e-4 with decays far from 1, where each score is a product of factors up to
e^{±15} and carries their rounding), against the scans atol 1e-4 (the reference's own 1e-3 bound, tightened);
logits atol 2e-4 (the standard of `tests/test_torch_family.py`); state
leaves and pools atol 1e-4 + rtol 1e-4 (a recurrent state sums every
earlier token's update, so the f32 differences of a whole-model pass
accumulate there: 1.5e-5 seen on a gla state element of 0.17); forward =
decode 2e-3 (the reference's `tests/test_models.py` bound); the training
step's loss and gradient norm rtol 1e-5, gradients atol 1e-5 of the leaf's
largest |g| (5x the transformer's 2e-6 of `tests/test_torch_train.py`: the
chunked forms' gradients pass through sums of exponentials; 5.4e-8 of a
largest 0.023 seen)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustered_params as ref_cp
from repro.core.api import ClusteredTensor as RefClusteredTensor
from repro.core.api import default_predicate as ref_default_predicate
from repro.core.lut import pack_codes as ref_pack_codes
from repro.kernels.ops import lut_serving
from repro.models import config as ref_config
from repro.models import gla as ref_gla
from repro.models import linear_attn as ref_la
from repro.models import params as ref_params_mod
from repro.models import rwkv6 as ref_rwkv6
from repro.models import zamba2 as ref_zamba2
from repro.models.registry import lm_loss as ref_lm_loss
from repro_torch.convert import from_reference
from repro_torch.core.api import ClusteredTensor, default_predicate
from repro_torch.models import config as port_config
from repro_torch.models import gla as port_gla
from repro_torch.models import layers as port_layers
from repro_torch.models import linear_attn as port_la
from repro_torch.models import params as port_params_mod
from repro_torch.models import rwkv6 as port_rwkv6
from repro_torch.models import zamba2 as port_zamba2
from repro_torch.models.params import iter_table
from repro_torch.models.registry import PORTED_FAMILIES, get_model, lm_loss

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (_cluster_one, assert_close, assert_equal, np_of, port_model,
                  reference_model, to_numpy_tree)

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

ARCHS = ("rwkv6-1.6b", "gla-1.3b", "zamba2-1.2b")
REF_MODULES = {"rwkv6-1.6b": ref_rwkv6, "gla-1.3b": ref_gla, "zamba2-1.2b": ref_zamba2}
PORT_MODULES = {"rwkv6-1.6b": port_rwkv6, "gla-1.3b": port_gla, "zamba2-1.2b": port_zamba2}
# rwkv6 and gla at 2 layers; zamba2 at its reduced 4 (two sites of attn_period 2)
LAYERS = {"rwkv6-1.6b": 2, "gla-1.3b": 2, "zamba2-1.2b": 4}
# gla's gate LoRA stays dense: clustered, it raises in the reference (ROADMAP C)
DENSE_IN_LCD = ("gate_A", "gate_B")


def _port_tree(tree):
    return from_reference(to_numpy_tree(tree), device="cpu")


def pair(arch, seed=0, **overrides):
    """(reference model, its dense params, port model) at `reduced()`, f32."""
    overrides.setdefault("n_layers", LAYERS[arch])
    model, params = reference_model(arch, seed=seed, **overrides)
    return model, params, port_model(arch, **overrides)


def cluster_family(model, params, nbits=4, act_scale=None, smooth_seed=None,
                   dense=DENSE_IN_LCD):
    """The reference's dense params with every leaf its `materialize_clustered`
    clusters (`clustered_params._eligible` on the table) replaced by a
    reference ClusteredTensor of quantile-clustered codes, stacked (L, ...)
    or, for zamba2's shared block, unstacked; leaves named in `dense` stay
    dense. `smooth_seed` draws smoothing vectors in [0.5, 1.5]; `act_scale`
    arms the quantized Eq. 11 transform."""
    rng = np.random.default_rng(smooth_seed)
    flat = jax.tree_util.tree_flatten_with_path(
        model.table, is_leaf=lambda d: isinstance(d, ref_params_mod.ParamDecl))[0]
    take = {jax.tree_util.keystr(kp) for kp, d in flat if ref_cp._eligible(
        jax.tree_util.keystr(kp), d) and not any(f"'{n}'" in jax.tree_util.keystr(kp)
                                                  for n in dense)}

    def one(w):
        w = np.asarray(w, np.float32)
        stacked = w.ndim == 3
        w3 = w if stacked else w[None]
        n_l, d_in, _ = w3.shape
        s = (np.ones((n_l, d_in), np.float32) if smooth_seed is None else
             rng.uniform(0.5, 1.5, (n_l, d_in)).astype(np.float32))
        pairs = [_cluster_one(w3[l] * s[l][:, None], 1 << nbits) for l in range(n_l)]
        codes = np.stack([c for c, _ in pairs])
        sq = 1.0 if act_scale is None else float(act_scale)
        fields = dict(codes=codes.astype(np.int8), codebook=np.stack([cb for _, cb in pairs]),
                      smooth=s, packed=np.stack([ref_pack_codes(codes[l], nbits)
                                                 for l in range(n_l)]),
                      inv_scale=(1.0 / (s * sq)).astype(np.float32),
                      act_scale=None if act_scale is None else np.full((n_l,), sq, np.float32))
        return RefClusteredTensor(nbits=nbits, **{
            k: None if v is None else jnp.asarray(v if stacked else v[0])
            for k, v in fields.items()})

    def walk(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}['{k}']"
            out[k] = walk(v, path) if isinstance(v, dict) else (one(v) if path in take else v)
        return out
    return walk(params)


VARIANTS = {"dense": None, "lcd_float": dict(act_scale=None), "lcd_quant": dict(act_scale=0.06)}


def _variant_params(model, params, variant):
    if VARIANTS[variant] is None:
        return params
    return cluster_family(model, params, 4, smooth_seed=2, **VARIANTS[variant])


def _serving_ctx(variant):
    return lut_serving("interpret" if variant != "dense" else None)


# ---------------------------------------------------------------------------
# configs, tables, init
# ---------------------------------------------------------------------------

DERIVED = ("hd", "padded_vocab", "d_inner", "ssm_heads", "rwkv_heads", "is_encdec")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_config_equal_the_reference(arch):
    """Every field and derived width (d_inner, ssm_heads, rwkv_heads among
    them) of the registered config and of its `reduced()` form equals the
    reference's, and so does the closed-form `param_count`; the family is
    ported."""
    for make in (lambda m, a: m.get_config(a), lambda m, a: m.reduced(m.get_config(a))):
        ref, port = make(ref_config, arch), make(port_config, arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for f in DERIVED:
            assert getattr(port, f) == getattr(ref, f), f
        assert port.param_count() == ref.param_count()
        assert port.param_count(active_only=True) == ref.param_count(active_only=True)
    assert get_model(arch).cfg.family in PORTED_FAMILIES


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_table_and_count_equal_the_reference(arch, full):
    """`param_table` keys, shapes, sharding names, inits and dtypes equal the
    reference's (zamba2's unstacked shared block among them); the table
    counts the same parameters."""
    if full:
        rcfg, pcfg = ref_config.get_config(arch), port_config.get_config(arch)
    else:
        rcfg, pcfg = reference_model(arch)[0].cfg, port_model(arch).cfg
    rt, pt = REF_MODULES[arch].param_table(rcfg), PORT_MODULES[arch].param_table(pcfg)
    ref_decl = {jax.tree_util.keystr(kp): d for kp, d in jax.tree_util.tree_flatten_with_path(
        rt, is_leaf=lambda d: hasattr(d, "names"))[0]}
    port = dict(iter_table(pt))
    assert sorted(port) == sorted(ref_decl)
    for path, d in port.items():
        r = ref_decl[path]
        assert (d.shape, d.names, d.init, d.dtype) == (r.shape, r.names, r.init, r.dtype), path
    assert get_model(pcfg).param_count() == ref_params_mod.param_count(rt)


def test_uniform_init_draws_inside_its_range():
    """The "uniform:lo~hi" init the recurrent tables use (decays, lerp
    coefficients, SSM dynamics): every value in [lo, hi], in the declared
    dtype, not constant."""
    gen = torch.Generator().manual_seed(3)
    for init, dt, lo, hi in (("uniform:-7.0~-5.0", "float32", -7.0, -5.0),
                             ("uniform:0.0~1.0", None, 0.0, 1.0)):
        d = port_params_mod.ParamDecl((64, 128), "layers,embed", init, dt)
        x = port_params_mod._init_one(gen, d, torch.bfloat16, "cpu")
        assert x.dtype == (torch.float32 if dt else torch.bfloat16)
        x = x.float()
        assert float(x.min()) >= lo and float(x.max()) <= hi and float(x.std()) > 0.1 * (hi - lo)
    with pytest.raises(ValueError, match="unknown init"):
        port_params_mod._init_one(gen, port_params_mod.ParamDecl((2,), "x", "bogus"),
                                  torch.float32, "cpu")


# ---------------------------------------------------------------------------
# the chunked forms
# ---------------------------------------------------------------------------

def _la_inputs(form, s, rng, strong=False):
    b, h, p = 2, 3, 8
    f = np.float32
    if form == "ssd":
        n = 6
        return dict(xh=rng.normal(size=(b, s, h, p)).astype(f),
                    Bt=rng.normal(size=(b, s, n)).astype(f),
                    Ct=rng.normal(size=(b, s, n)).astype(f),
                    dt=rng.uniform(0.01, 0.5 if not strong else 3.0, (b, s, h)).astype(f),
                    a_log=rng.uniform(0.0, 1.4, h).astype(f),
                    d_skip=rng.normal(size=h).astype(f),
                    s0=rng.normal(size=(b, h, p, n)).astype(f))
    lo = 0.05 if strong else 0.8
    out = dict(k=rng.normal(size=(b, s, h, p)).astype(f),
               v=rng.normal(size=(b, s, h, p)).astype(f),
               s0=rng.normal(size=(b, h, p, p)).astype(f))
    if form == "wkv6":
        out.update(r=rng.normal(size=(b, s, h, p)).astype(f),
                   w=rng.uniform(lo, 1.0, (b, s, h, p)).astype(f),
                   u=rng.normal(size=(h, p)).astype(f))
    else:
        out.update(qh=rng.normal(size=(b, s, h, p)).astype(f),
                   a=rng.uniform(lo, 1.0, (b, s, h, p)).astype(f))
    return out


CHUNKED = {
    "ssd": (("xh", "Bt", "Ct", "dt", "a_log", "d_skip", "s0"), "ssd_chunked",
            lambda a: port_zamba2._ssd_scan(*a)),
    "wkv6": (("r", "k", "v", "w", "u", "s0"), "wkv6_chunked",
             lambda a: port_rwkv6._wkv_scan(*a)),
    "gla": (("qh", "k", "v", "a", "s0"), "gla_chunked", lambda a: port_gla._gla_scan(*a)),
}


@pytest.mark.parametrize("case", ["s96", "s40", "strong"])
@pytest.mark.parametrize("form", sorted(CHUNKED))
def test_chunked_forms_equal_the_reference_and_the_scans(form, case):
    """Each chunked form against the reference's on the same inputs (96
    tokens: whole chunks; 40: the chunk length falls back to a divisor;
    "strong": decays far from 1, where the mid-chunk reference keeps the
    factors' exponents bounded), and against the port's own sequential
    scan, output and final state."""
    names, fn, scan = CHUNKED[form]
    s = 40 if case == "s40" else 96
    arrays = _la_inputs(form, s, np.random.default_rng(len(case) * 7 + len(form)),
                        strong=case == "strong")
    args = [arrays[n] for n in names]
    want_y, want_s = getattr(ref_la, fn)(*[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a) for a in args]
    got_y, got_s = getattr(port_la, fn)(*targs)
    tol = 1e-4 if case == "strong" else 1e-5
    assert_close(np_of(got_y), np.asarray(want_y), rtol=tol, atol=tol, what=f"{form} y")
    assert_close(np_of(got_s), np.asarray(want_s), rtol=tol, atol=tol, what=f"{form} state")
    scan_y, scan_s = scan(targs)
    assert_close(np_of(got_y), np_of(scan_y), atol=1e-4, rtol=1e-4, what=f"{form} y vs scan")
    assert_close(np_of(got_s), np_of(scan_s), atol=1e-4, rtol=1e-4, what=f"{form} state vs scan")


def test_chunked_forms_run_in_full_f32_under_tf32_and_in_the_backward():
    """The chunked forms' products go through `layers._einsum`, which sets
    full f32 for its forward and its backward whatever the caller set, and
    restores the caller's setting; the gradient of a chunked form is that
    of the sequential scan."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        arrays = _la_inputs("gla", 64, np.random.default_rng(5))
        targs = [torch.from_numpy(arrays[n]).requires_grad_(n == "k")
                 for n in ("qh", "k", "v", "a", "s0")]
        y, _ = port_la.gla_chunked(*targs)
        (g_chunk,) = torch.autograd.grad(y.square().sum(), targs[1])
        y2, _ = port_gla._gla_scan(*targs)
        (g_scan,) = torch.autograd.grad(y2.square().sum(), targs[1])
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert_close(np_of(g_chunk), np_of(g_scan), rtol=1e-4, atol=1e-3 * float(g_scan.abs().max()),
                 what="d y^2 / dk, chunked vs scan")


def test_row_stable_matmul_gives_a_row_the_same_bits_at_1_to_16_rows():
    """The decay / gate LoRA product pads fewer than 16 rows to 16, so a
    slot's row does not depend on how many slots share the step."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((16, 64), generator=gen)
    w = torch.randn((64, 32), generator=gen)
    full = port_layers.row_stable_matmul(x, w)
    for r in (1, 3, 8, 16):
        assert torch.equal(port_layers.row_stable_matmul(x[:r], w), full[:r])
    assert_close(np_of(full), np_of(x) @ np_of(w), rtol=1e-5, atol=1e-5, what="x @ w")
    x3 = x.reshape(2, 8, 64)
    assert torch.equal(port_layers.row_stable_matmul(x3, w), full.reshape(2, 8, 32))


# ---------------------------------------------------------------------------
# whole models against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_the_reference(arch, variant):
    """`Model.apply` (the chunked forms over 24 tokens: a chunk of 16 and
    its fallback) on the same converted params and tokens as the
    reference's."""
    model, params, pmodel = pair(arch, seed=1)
    params = _variant_params(model, params, variant)
    tokens = np.random.default_rng(4).integers(0, model.cfg.vocab, (2, 24)).astype(np.int32)
    with _serving_ctx(variant):
        want, _ = jax.jit(model.apply)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = pmodel.apply(_port_tree(params), {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0
    assert_close(np_of(got), np.asarray(want), atol=2e-4, what=f"{arch}/{variant} logits")


def _cache_leaves_close(got, want, what):
    for name, w in want.items():
        if name == "pos":
            assert int(np_of(got[name])) == int(np.asarray(w)), f"{what}: pos"
            continue
        assert_close(np_of(got[name]), np.asarray(w), rtol=1e-4, atol=1e-4,
                     what=f"{what}: {name}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_equals_the_reference(arch, variant):
    """The static path: a 6-token prompt in one call, then three one-token
    steps (explicit positions, as the reference's callers pass them), on
    the same converted params and cache: last-token logits and every cache
    leaf after each call."""
    model, params, pmodel = pair(arch, seed=2)
    params = _variant_params(model, params, variant)
    rng = np.random.default_rng(6)
    cache = model.init_cache(2, 16)
    pparams, pcache = _port_tree(params), _port_tree(cache)
    pos = 0
    ref_dec = jax.jit(model.decode)
    for i, s in enumerate((6, 1, 1, 1)):
        tokens = rng.integers(0, model.cfg.vocab, (2, s)).astype(np.int32)
        with _serving_ctx(variant):
            want, cache = ref_dec(params, cache, {"tokens": jnp.asarray(tokens),
                                                  "pos": jnp.asarray(pos, jnp.int32)})
        got, pcache = pmodel.decode(pparams, pcache, {"tokens": torch.from_numpy(tokens),
                                                      "pos": pos})
        what = f"{arch}/{variant} call {i}"
        assert_close(np_of(got), np.asarray(want), atol=2e-4, what=f"{what} logits")
        _cache_leaves_close(pcache, cache, what)
        pos += s


def _serving_steps(cfg, S, T, rng):
    """A prefill-width step (ragged n_new, slot 1 idle), a second one that
    finishes the prompts, then two decode steps."""
    n_first = np.array([T, 0, T - 3, 2][:S], np.int32)
    steps = [(rng.integers(0, cfg.vocab, (S, T)).astype(np.int32), n_first),
             (rng.integers(0, cfg.vocab, (S, T)).astype(np.int32),
              np.where(n_first > 0, T - 1, 0).astype(np.int32))]
    for _ in range(2):
        steps.append((rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32),
                      (n_first > 0).astype(np.int32)))
    return steps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_step_equals_the_reference(arch, variant):
    """The engine's step (`Model.serving_step`, one token at a time over a
    (slots, 8) window) on the same converted params and caches as the
    reference's: the logits of every live slot and every state leaf (and
    zamba2's site pools) after each of four steps; an idle slot's state
    stays zero in both."""
    model, params, pmodel = pair(arch, seed=3)
    cfg = model.cfg
    params = _variant_params(model, params, variant)
    rng = np.random.default_rng(11)
    S, T, nb, bs, nbw = 4, 8, 24, 4, 6
    caches = model.init_seq_caches(num_blocks=nb, block_size=bs, num_slots=S,
                                   max_seq=nbw * bs)
    pparams, pcaches = _port_tree(params), _port_tree(caches)
    tables = rng.permutation(nb).reshape(S, nbw).astype(np.int32)
    steps = _serving_steps(cfg, S, T, rng)
    live = steps[0][1] > 0
    ref_step = jax.jit(model.serving_step)
    lengths = np.zeros(S, np.int32)
    for i, (tokens, n_new) in enumerate(steps):
        args = (tokens, lengths, n_new, tables)
        with _serving_ctx(variant):
            want, caches = ref_step(params, caches, *[jnp.asarray(a) for a in args])
        got, out = pmodel.serving_step(pparams, pcaches, *[torch.from_numpy(a) for a in args])
        assert out is pcaches and got.shape == (S, cfg.padded_vocab)
        what = f"{arch}/{variant} step {i}"
        assert_close(np_of(got)[live], np.asarray(want)[live], atol=2e-4, what=f"{what} logits")
        for kind in caches:
            _cache_leaves_close(pcaches[kind], caches[kind], f"{what} {kind}")
        lengths = lengths + n_new
    for name, t in pcaches["slot"].items():
        assert not t[:, 1].any(), f"idle slot 1: {name} was written"


def test_zamba2_shorter_than_its_period_equals_the_reference():
    """One mamba layer under an attention period of 2: a single site after
    it (the reference's `a[0:per]` slices give that, and its trailing
    `a[-rem:]` with rem < 0 is empty): the forward and a serving step equal
    the reference's."""
    model, params, pmodel = pair("zamba2-1.2b", seed=8, n_layers=1)
    assert model.cfg.attn_period == 2 and ref_zamba2.n_sites(model.cfg) == 1
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, model.cfg.vocab, (2, 6)).astype(np.int32)
    want, _ = model.apply(params, {"tokens": jnp.asarray(tokens)})
    pp = _port_tree(params)
    with torch.no_grad():
        got, _ = pmodel.apply(pp, {"tokens": torch.from_numpy(tokens)})
    assert_close(np_of(got), np.asarray(want), atol=2e-4, what="forward")
    caches = model.init_seq_caches(num_blocks=8, block_size=4, num_slots=2, max_seq=16)
    pcaches = _port_tree(caches)
    args = (tokens, np.zeros(2, np.int32), np.array([6, 3], np.int32),
            np.arange(8, dtype=np.int32).reshape(2, 4))
    want, caches = model.serving_step(params, caches, *[jnp.asarray(a) for a in args])
    got, _ = pmodel.serving_step(pp, pcaches, *[torch.from_numpy(a) for a in args])
    assert_close(np_of(got), np.asarray(want), atol=2e-4, what="serving_step logits")
    for kind in caches:
        _cache_leaves_close(pcaches[kind], caches[kind], f"serving_step {kind}")


def _zamba2_site_norms(mods, params, tokens, cfg, to, rms):
    """The residual stream's RMS over every token after the embedding and
    after each attention site of a zamba2 forward, walked with a package's
    own blocks (`mods`: its zamba2 and layers modules; `to` makes its
    arrays, `rms` reads one back)."""
    zam, lay = mods
    x = params["embed"][to(tokens)]
    norms = [rms(x)]
    per = cfg.attn_period
    for site in range(zam.n_sites(cfg)):
        for l in range(site * per, (site + 1) * per):
            p = {k: (v[l] if not isinstance(v, dict) else {kk: vv[l] for kk, vv in v.items()})
                 for k, v in params["blocks"].items()}
            h, _ = zam.mamba_block(p, lay.rmsnorm(x, p["ln"]["scale"]), cfg, None)
            x = x + h
        out = zam._shared_attn(params, x, cfg)
        x = out[0] if isinstance(out, tuple) else out
        norms.append(rms(x))
    return np.array(norms)


def test_zamba2_at_12_layers_grows_its_residual_as_the_reference_does():
    """The check behind `recurrent_parity`'s 2-layer zamba2: at 12 layers
    (6 attention sites) the random weights' residual stream grows in the
    reference, and the port's grows the same way: from the same params and
    tokens, the stream's RMS after each site within 1e-4 (relative) of the
    reference's, and the logits within 1e-4 of their largest magnitude. A
    reference property of random weights, not a port fault."""
    from repro.models import layers as ref_lay
    model, params, pmodel = pair("zamba2-1.2b", seed=0, n_layers=12)
    cfg = model.cfg
    assert ref_zamba2.n_sites(cfg) == 6
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want = _zamba2_site_norms((ref_zamba2, ref_lay), params, tokens, cfg, jnp.asarray,
                              lambda x: float(jnp.sqrt(jnp.mean(jnp.square(x)))))
    pp = _port_tree(params)
    with torch.no_grad():
        got = _zamba2_site_norms((port_zamba2, port_layers), pp, tokens, pmodel.cfg,
                                 lambda t: torch.from_numpy(t).long(),
                                 lambda x: float(torch.sqrt(torch.mean(torch.square(x)))))
        logits, _ = pmodel.apply(pp, {"tokens": torch.from_numpy(tokens)})
    ref_logits, _ = model.apply(params, {"tokens": jnp.asarray(tokens)})
    assert_close(got, want, rtol=1e-4, what="residual RMS per site")
    scale = float(np.abs(np.asarray(ref_logits)).max())
    assert_close(np_of(logits), np.asarray(ref_logits), atol=1e-4 * scale,
                 what="12-layer logits, relative to their largest")
    assert want[-1] > 10 * want[0], want       # the stream grows, in both


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_decode_within_the_reference_bound(arch):
    """The full-sequence forward (chunked forms) against token-by-token
    decode (the sequential recurrence) in the port, within the reference's
    own 2e-3 (`tests/test_models.py::test_decode_matches_forward`)."""
    pmodel = port_model(arch, n_layers=LAYERS[arch])
    cfg = pmodel.cfg
    params = pmodel.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        logits, _ = pmodel.apply(params, {"tokens": tokens})
    cache = pmodel.init_cache(2, 16, device="cpu")
    errs = []
    for i in range(8):
        lg, cache = pmodel.decode(params, cache, {"tokens": tokens[:, i:i + 1], "pos": i})
        errs.append(float((lg - logits[:, i]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_one_train_step_of_rwkv6_equals_the_reference():
    """One `build_train_step` step of reduced rwkv6 (2 layers, seq 16) in
    both packages on the same params and batch (the port's
    `launch/steps.py` is generic over the family): the loss and the gradient
    norm, and the raw gradients through each package's own autograd."""
    from repro.distributed.sharding import use_rules
    from repro.launch import steps as ref_steps
    from repro.launch.mesh import make_host_mesh
    from repro.optim import optimizer as ref_opt
    from repro_torch.launch import steps as port_steps
    from repro_torch.optim import optimizer as port_opt
    from repro_torch.tree import leaves
    from repro_torch.tree import unflatten as port_unflatten

    model, params, pmodel = pair("rwkv6-1.6b", seed=4)
    vocab = model.cfg.vocab
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, vocab, (2, 16)).astype(np.int32),
             "targets": rng.integers(0, vocab, (2, 16)).astype(np.int32),
             "loss_mask": (rng.random((2, 16)) > 0.2).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = ref_opt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    with use_rules(make_host_mesh()):
        b = ref_steps.build_train_step(model, ref_config.ShapeConfig("t", 16, 2, "train"), opt)
        fn = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
        from repro.optim import compress as ref_compress
        _, _, _, want_m = fn(params, ref_opt.init_adam(params), ref_compress.EFState(None), jb)
    pp = _port_tree(params)
    from repro_torch.distributed.sharding import use_rules as port_use_rules
    from repro_torch.launch.mesh import make_host_mesh as port_make_host_mesh
    with port_use_rules(port_make_host_mesh([torch.device("cpu")])):
        step = port_steps.build_train_step(pmodel, port_config.ShapeConfig("t", 16, 2, "train"),
                                           port_opt.OptConfig(**dataclasses.asdict(opt)))
    from repro_torch.optim import compress as port_compress
    _, got_o, _, got_m = step(pp, port_opt.init_adam(pp), port_compress.EFState(None), tb)
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]), rel=1e-5)
    assert float(got_m["grad_norm"]) == pytest.approx(float(want_m["grad_norm"]), rel=1e-5)
    assert int(got_o.step) == 1

    def ref_loss(p):
        logits, _ = model.apply(p, jb)
        return ref_lm_loss(logits, jb["targets"], jb["loss_mask"], vocab)
    ref_grads = jax.tree_util.tree_leaves(jax.grad(ref_loss)(params))
    var = [x.detach().requires_grad_(True) for x in leaves(pp)]
    logits, _ = pmodel.apply(port_unflatten(pp, var), tb)
    port_grads = torch.autograd.grad(lm_loss(logits, tb["targets"], tb["loss_mask"], vocab), var)
    assert len(port_grads) == len(ref_grads)
    for got, want in zip(port_grads, ref_grads):
        want = np.asarray(want)
        assert_close(np_of(got), want, atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
                     what="gradient")


# ---------------------------------------------------------------------------
# the two reference properties the port reproduces
# ---------------------------------------------------------------------------

def test_a_clustered_gla_gate_lora_raises_in_both_packages():
    """`default_predicate` (compress_model) and `materialize_clustered` take
    gla's forget-gate LoRA (`gate_A` (L, d, 64), `gate_B` (L, 64, d)): the
    exclusion regex names `gate_w`, not `gate_`. The reference's
    `xg @ p["gate_A"]` then raises TypeError on the ClusteredTensor, and the
    port's gate product raises where it does; the port adds no dequantising
    fallback."""
    model, params, pmodel = pair("gla-1.3b", seed=5)
    for path, shape in (("['blocks']['attn']['gate_A']", (2, 128, 64)),
                        ("['blocks']['attn']['gate_B']", (2, 64, 128))):
        assert ref_default_predicate(path, np.zeros(shape, np.float32))
        assert default_predicate(path, torch.zeros(shape))
    shapes, _, _ = ref_cp.clustered_abstract(model)
    assert isinstance(shapes["blocks"]["attn"]["gate_A"], RefClusteredTensor)
    params = cluster_family(model, params, dense=())
    assert isinstance(params["blocks"]["attn"]["gate_A"], RefClusteredTensor)
    tokens = np.zeros((1, 1), np.int32)
    cache = model.init_cache(1, 4)
    with pytest.raises(TypeError):
        model.decode(params, cache, {"tokens": jnp.asarray(tokens), "pos": jnp.int32(0)})
    with pytest.raises(TypeError):
        pmodel.decode(_port_tree(params), _port_tree(cache),
                      {"tokens": torch.from_numpy(tokens), "pos": 0})


def test_a_clustered_zamba2_d_skip_raises_in_both_packages():
    """At full depth zamba2's `d_skip` is (38, 64): 2-D, its smaller side 38
    >= 32, and the exclusion regex does not name it, so `default_predicate`
    (compress_model) takes it in both packages, while `materialize_clustered`
    (one logical dim besides "layers") does not. A clustered `d_skip` then
    meets `d_skip[None, None, :, None]` and raises TypeError in the
    reference's mamba block and in the port's. At `reduced()` it is (4, 32)
    and never clustered."""
    path = "['blocks']['d_skip']"
    full = ref_config.get_config("zamba2-1.2b")
    shape = (full.n_layers, full.ssm_heads)
    assert shape == (38, 64)
    assert ref_default_predicate(path, np.ones(shape, np.float32))
    assert default_predicate(path, torch.ones(shape))
    assert not ref_default_predicate(path, np.ones((4, 32), np.float32))
    decl = dict(iter_table(port_zamba2.param_table(port_config.get_config("zamba2-1.2b"))))[path]
    assert not ref_cp._eligible(path, decl)
    model, params, pmodel = pair("zamba2-1.2b", seed=6)
    cfg = model.cfg
    p = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    ct = RefClusteredTensor(codes=jnp.zeros((1, cfg.ssm_heads), jnp.int8),
                            codebook=jnp.ones((16,), jnp.float32),
                            smooth=jnp.ones((1,), jnp.float32),
                            packed=jnp.zeros((1, cfg.ssm_heads), jnp.uint8), nbits=4)
    x = np.random.default_rng(0).normal(size=(1, 3, cfg.d_model)).astype(np.float32)
    with pytest.raises(TypeError):
        ref_zamba2.mamba_block({**p, "d_skip": ct}, jnp.asarray(x), cfg, None)
    pp = {k: from_reference(to_numpy_tree(v), device="cpu") for k, v in p.items()}
    pct = ClusteredTensor(torch.zeros((1, cfg.ssm_heads), dtype=torch.uint8),
                          torch.ones(16), torch.ones(1), nbits=4)
    with pytest.raises(TypeError):
        port_zamba2.mamba_block({**pp, "d_skip": pct}, torch.from_numpy(x), pmodel.cfg, None)


def test_convert_keeps_the_recurrent_f32_leaves_in_a_bf16_model():
    """`from_reference(..., dtype=bfloat16)` casts the projections and the
    model-dtype state (rwkv6's shifted tokens, zamba2's conv window) and
    keeps the f32 leaves f32: the dynamics parameters, the mamba conv
    weight and the recurrent state."""
    for arch in ARCHS:
        model, params, pmodel = pair(arch, seed=7, dtype="bfloat16")
        pp = from_reference(to_numpy_tree(params), device="cpu", dtype=torch.bfloat16)
        caches = from_reference(to_numpy_tree(model.init_seq_caches(
            num_blocks=4, block_size=4, num_slots=2, max_seq=16)), device="cpu",
            dtype=torch.bfloat16)
        want = pmodel.init(torch.Generator().manual_seed(0), device="cpu")
        for (path, got), (_, w) in zip(_leaves(pp), _leaves(want)):
            assert got.dtype == w.dtype, (arch, path)
        want_c = pmodel.init_seq_caches(num_blocks=4, block_size=4, num_slots=2,
                                        max_seq=16, device="cpu")
        for kind in want_c:
            for name, t in want_c[kind].items():
                assert caches[kind][name].dtype == t.dtype, (arch, kind, name)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


# ---------------------------------------------------------------------------
# every family the reference serves is ported
# ---------------------------------------------------------------------------

def test_ported_families_cover_every_family_of_the_reference():
    """`PORTED_FAMILIES` holds every family of `FAMILY_CAPS` (the reference's
    capability table), and `get_model` builds every registered arch with
    its family's capabilities; the slot protocols snapshot where the
    reference's do (rwkv6, gla, whisper) and not for zamba2."""
    from repro.models import registry as ref_registry
    from repro_torch.models.config import list_archs
    from repro_torch.models.registry import FAMILY_CAPS
    assert sorted(PORTED_FAMILIES) == sorted(FAMILY_CAPS) == sorted(ref_registry._FAMILIES)
    for arch in list_archs():
        model = get_model(arch)
        assert model.capabilities == FAMILY_CAPS[model.cfg.family], arch
    for arch, snap in (("rwkv6-1.6b", True), ("gla-1.3b", True), ("zamba2-1.2b", False),
                       ("whisper-large-v3", True)):
        assert get_model(arch).seq_caches["slot"].snapshot == snap, arch
