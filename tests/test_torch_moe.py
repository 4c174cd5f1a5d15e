"""The mixture-of-experts family in the port — phi3.5-moe-42b-a6.6b (16
experts, top-2) and llama4-scout-17b-a16e (16 experts, top-1, padded heads)
— against the reference on `reduced()` configs (4 experts; top-2 and
top-1): the configs and parameter tables, `resolve_weight` on stacked
experts, `moe_block` with and without capacity drops, the full-sequence
forward with its aux loss, the paged step over float and int8 pools, the
compression pipeline (which leaves the 4-D experts dense) and one training
step. The engine in lockstep with the reference is in
`tests/test_torch_moe_engine.py`.

Tolerances: configs, tables, codes, packed bytes and the drops exact;
`resolve_weight` torch.equal; `moe_block` out rtol 1e-6 (atol 1e-6 of its
largest |value|) and aux rtol 1e-6 in f32, and in bf16 one bf16 ulp of the
output's scale (2**-7 of its largest |value|), the standard the reference's
own bf16 checks use for a bf16 result; logits atol 2e-4 (the standard of
`tests/test_torch_family.py`), aux rtol 1e-5; float pools rtol 1e-6 atol
1e-5; int8 codes one step on at most 0.1 % of the entries and scales rtol
1e-6 after every step, each step from the reference's pools (see the
paged-step test)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import api as ref_api
from repro.core import clustered_params as ref_cp
from repro.core import hessian as ref_hessian
from repro.core.api import ClusteredTensor as RefClusteredTensor
from repro.kernels.ops import lut_serving
from repro.models import config as ref_config
from repro.models import layers as ref_layers
from repro.models import params as ref_params_mod
from repro.models import transformer as ref_tf
from repro_torch.convert import from_reference
from repro_torch.core import api as port_api
from repro_torch.core import clustered_params as port_cp
from repro_torch.core import hessian as port_hessian
from repro_torch.core.api import is_clustered
from repro_torch.kernels import ops as port_ops
from repro_torch.models import config as port_config
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_tf
from repro_torch.models.params import iter_table
from repro_torch.models.registry import PORTED_FAMILIES, get_model

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (CT_FIELDS, assert_close, assert_equal, cluster_params, np_of,
                  port_model, reference_model, to_numpy_tree)
from test_torch_compress import _assert_same_compression
from test_torch_family import _lively

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _port_tree(tree):
    return from_reference(to_numpy_tree(tree), device="cpu")


def cluster_moe(params, nbits=4, act_scale=None, smooth_seed=None):
    """`cluster_params` for an MoE tree: attention as there, and each
    stacked expert leaf (L, E, d_in, d_out) clustered per (layer, expert)
    into a reference ClusteredTensor with (L, E, ...) fields — the layout
    `materialize_clustered` gives; the router stays dense."""
    mlp = params["blocks"]["mlp"]
    rest = cluster_params({**params, "blocks": {**params["blocks"],
                                                "mlp": {"router": mlp["router"]}}},
                          nbits, act_scale=act_scale, smooth_seed=smooth_seed)
    n_l, n_e = mlp["w_gate"].shape[:2]
    flat = cluster_params({k: jnp.reshape(mlp[k], (n_l * n_e,) + mlp[k].shape[2:])
                           for k in EXPERT_LEAVES}, nbits, act_scale=act_scale,
                          smooth_seed=None if smooth_seed is None else smooth_seed + 1)

    def unflat(ct):
        return RefClusteredTensor(nbits=ct.nbits, **{
            f: None if getattr(ct, f) is None else
            jnp.reshape(getattr(ct, f), (n_l, n_e) + getattr(ct, f).shape[1:])
            for f in CT_FIELDS})
    rest["blocks"]["mlp"].update({k: unflat(flat[k]) for k in EXPERT_LEAVES})
    return rest


# ---------------------------------------------------------------------------
# configs, tables, init, eligibility
# ---------------------------------------------------------------------------

DERIVED = ("hd", "padded_vocab", "n_heads_eff", "q_dim_eff", "q_dim", "kv_dim")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_config_equal_the_reference(arch):
    """Every field and derived width of the registered config and of its
    `reduced()` form (4 experts; top-2 / top-1; llama4-scout's padded heads)
    equals the reference's; the family is ported and its full-size model
    builds."""
    for make in (lambda m, a: m.get_config(a), lambda m, a: m.reduced(m.get_config(a))):
        ref, port = make(ref_config, arch), make(port_config, arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for f in DERIVED:
            assert getattr(port, f) == getattr(ref, f), f
    red = port_config.reduced(port_config.get_config(arch))
    assert (red.n_experts, red.moe_topk) == (4, 2 if arch.startswith("phi") else 1)
    assert arch in port_config.list_archs() and "moe" in PORTED_FAMILIES
    assert get_model(arch).cfg.family == "moe"


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_table_and_count_equal_the_reference(arch, full):
    """`param_table` keys, shapes, sharding names, inits and dtypes equal the
    reference's, the router (L, d, E) and the stacked experts (L, E, d, f) /
    (L, E, f, d) among them; `Model.param_count` counts the table, experts
    included, as the reference's table count does."""
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
    e, L, dm, f = pcfg.n_experts, pcfg.n_layers, pcfg.d_model, pcfg.d_ff
    mlp = {k: port[f"['blocks']['mlp']['{k}']"].shape for k in ("router",) + EXPERT_LEAVES}
    assert mlp == {"router": (L, dm, e), "w_gate": (L, e, dm, f), "w_up": (L, e, dm, f),
                   "w_down": (L, e, f, dm)}
    n = get_model(pcfg).param_count()
    assert n == ref_params_mod.param_count(rt)
    assert n > 3 * L * e * dm * f


def test_fanin_init_of_stacked_experts_matches_the_reference():
    """The port's init (its own generator) and the reference's (its key):
    every leaf's mean 0 and standard deviation the same to 3 %, the 4-D
    expert leaves at 1 / sqrt(shape[-2]) (their fan-in: d for w_gate /
    w_up, f for w_down), the router at 1 / sqrt(d)."""
    model, ref = reference_model("phi3.5-moe-42b-a6.6b", seed=3)
    pm = port_model("phi3.5-moe-42b-a6.6b")
    port = pm.init(torch.Generator().manual_seed(3), device="cpu")
    want, got = to_numpy_tree(ref), {k: np_of(v) for k, v in port["blocks"]["mlp"].items()}
    for k, g in got.items():
        w = want["blocks"]["mlp"][k]
        decl = pm.table["blocks"]["mlp"][k]
        std = 1.0 / np.sqrt(decl.shape[-2])
        assert abs(g.std() / std - 1) < 0.03 and abs(w.std() / std - 1) < 0.03, k
        assert abs(g.mean()) < 0.05 * std, k
    assert from_reference(want, device="cpu")["blocks"]["mlp"]["w_gate"].shape == (4, 4, 128, 256)


@pytest.mark.parametrize("arch", ARCHS)
def test_clustered_eligibility_and_shapes_equal_the_reference(arch):
    """`_eligible` per table path equals the reference's: the four
    attention projections and the three stacked expert leaves are
    eligible, the router is not; `clustered_abstract` gives the same
    stats, the experts with (L, E, 16) codebooks and (L, E, d_in) smoothing
    vectors, as `materialize_clustered` fills them."""
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
    assert got == want and sum(got.values()) == 7
    assert not got["['blocks']['mlp']['router']"]
    cfg = pm.cfg
    ct = shapes["blocks"]["mlp"]["w_down"]
    assert ct.codebook == (cfg.n_layers, cfg.n_experts, 16)
    assert ct.smooth == (cfg.n_layers, cfg.n_experts, cfg.d_ff)
    mat = port_cp.materialize_clustered(pm, torch.Generator().manual_seed(0), device="cpu")
    leaf = mat["blocks"]["mlp"]["w_up"]
    assert is_clustered(leaf) and tuple(leaf.codebook.shape) == (cfg.n_layers, cfg.n_experts, 16)
    assert tuple(leaf.codes.shape) == (cfg.n_layers, cfg.n_experts, cfg.d_model // 2, cfg.d_ff)
    assert port_cp.packed_weight_bytes(mat) == ref_cp.packed_weight_bytes(
        ref_cp.materialize_clustered(model, jax.random.key(0), nbits=4))


def test_hessian_broadcast_over_stacked_experts_equals_the_reference():
    """`diag_hessian_for_weight` on (E, d_in, d_out) equals the reference's;
    a 4-D shape is refused by both."""
    x = np.random.default_rng(0).normal(size=(6, 5, 64)).astype(np.float32)
    want = np.asarray(ref_hessian.diag_hessian_for_weight(jnp.asarray(x), (4, 64, 32)))
    got = np_of(port_hessian.diag_hessian_for_weight(torch.from_numpy(x), (4, 64, 32)))
    assert_close(got, want, rtol=1e-6, what="stacked diag H")
    with pytest.raises(ValueError):
        port_hessian.diag_hessian_for_weight(torch.from_numpy(x), (2, 4, 64, 32))
    with pytest.raises(ValueError):
        ref_hessian.diag_hessian_for_weight(jnp.asarray(x), (2, 4, 64, 32))


# ---------------------------------------------------------------------------
# resolve_weight and moe_block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _clustered_experts(arch, seed=0):
    """(reference model, reference params with clustered experts and
    attention, quantized transform armed on the attention)."""
    model, dense = reference_model(arch, seed=seed, n_layers=2)
    return model, cluster_moe(_lively(dense, seed + 7), 4, act_scale=0.06,
                              smooth_seed=seed + 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "full_rows"])
def test_resolve_weight_of_stacked_experts_equals_the_reference(packed, dtype):
    """A clustered (E, d, f) expert leaf, codes packed or at full rows:
    the port's per-expert resolve (int32 indices, one expert at a time) is
    torch.equal to the whole-tensor route (int64 indices over the stack)
    and equal to the reference's `resolve_weight`, in f32 and bf16."""
    _, params = _clustered_experts("phi3.5-moe-42b-a6.6b")
    ref_leaf = jax.tree_util.tree_map(lambda a: a[1], params["blocks"]["mlp"]["w_down"])
    if packed:
        ref_leaf = ref_leaf._replace(codes=ref_leaf.packed)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np_of(ref_layers.resolve_weight(ref_leaf, jdt))
    leaf = _port_tree(ref_leaf)
    got = port_layers.resolve_weight(leaf, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (4, 256, 128)
    codes = port_api._unpack_codes(leaf.codes, leaf.smooth.shape[-1], leaf.nbits).long()
    whole = torch.stack([cb[cd] for cb, cd in zip(leaf.codebook, codes)])
    assert torch.equal(got, (whole / leaf.smooth[..., :, None]).to(tdt))
    assert_equal(np_of(got), want, "resolve_weight (exact)")


def _moe_case(case, arch, rng):
    """(router (d, E), x (B, S, d)) of one moe_block case:
    "fits" 2 x 2 tokens (one group of 4: at top-1 and top-2 the capacity
    is the group, nothing can drop); "drops" 4 x 40 tokens pulled towards expert 0, so its
    places run out; "tie" 2 x 48 tokens with experts 0 and 1 given the same
    router column (equal probabilities: the first index wins) and most
    tokens on them, so places run out too."""
    d, e = 128, 4
    router = (rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32)
    shape = {"fits": (2, 2), "drops": (4, 40), "tie": (2, 48)}[case]
    x = rng.normal(size=shape + (d,)).astype(np.float32)
    if case != "fits":
        u = rng.normal(size=d).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 2.0 * u
        router[:, 0] += 3.0 * u
        if case == "tie":
            router[:, 1] = router[:, 0]
    return router, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["fits", "drops", "tie"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_equals_the_reference(arch, case, dtype):
    """`moe_block` on one layer's experts (clustered, so through the stacked
    `resolve_weight`) against the reference's: out and aux. The port's
    routing (`moe_routing`) names the drops: none where the capacity is the
    whole group, some in the other cases (a token's place at its expert at
    or past the capacity, a zero row of the one-hot); in the tie case the
    first index wins (at top-1 no token goes to expert 1)."""
    model, params = _clustered_experts(arch)
    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    pcfg = port_model(arch, n_layers=2, dtype=dtype).cfg
    rng = np.random.default_rng({"fits": 1, "drops": 2, "tie": 3}[case])
    router, x = _moe_case(case, arch, rng)
    p_ref = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["mlp"])
    p_ref = {**p_ref, "router": jnp.asarray(router)}
    p_port = port_tf.layer_slice(_port_tree(params["blocks"]["mlp"]), 0)
    p_port["router"] = torch.from_numpy(router)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want, want_aux = ref_layers.moe_block(p_ref, jnp.asarray(x).astype(jdt), cfg)
    xt = torch.from_numpy(x).to(tdt)
    got, aux = port_layers.moe_block(p_port, xt, pcfg)
    assert got.dtype == tdt and aux.dtype == torch.float32
    want = np_of(want)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        assert_close(np_of(got), want, rtol=1e-6, atol=1e-6 * scale, what=f"{case} out")
    else:
        assert_close(np_of(got), want, atol=2.0 ** -7 * scale, what=f"{case} out (bf16)")
    assert_close(float(aux), float(want_aux), rtol=1e-6, what=f"{case} aux")

    b, s, d = x.shape
    g, sg = port_layers.moe_groups(b * s)
    r = port_layers.moe_routing(p_port["router"], xt.reshape(g, sg, d), pcfg.n_experts,
                                pcfg.moe_topk)
    places = r.dispatch.sum(dim=(2, 3))                        # (G, Sg): kept slots
    dropped = b * s * pcfg.moe_topk - int(places.sum())
    assert (dropped > 0) == (case != "fits"), (case, dropped, r.cap)
    assert (r.cap == sg) == (case == "fits")
    rows = (got.float().abs().sum(-1) == 0).reshape(-1)
    assert torch.equal(rows, (places == 0).reshape(-1)), \
        "a row is zero exactly where all its experts dropped it"
    if case == "tie":
        # experts 0 and 1 share one router column: every token that takes one
        # takes the other (top-2) or takes expert 0, the first index (top-1)
        probs = torch.softmax(xt.float().reshape(g, sg, d) @ p_port["router"], dim=-1)
        tied = probs.argmax(-1) == 0
        assert bool(tied.any()) and bool((probs[..., 0] == probs[..., 1]).all())
        if pcfg.moe_topk == 1:
            assert not bool(r.dispatch[..., 1, :][tied].any())


def test_moe_block_needs_no_host_sync_and_ignores_tf32():
    """The block builds its one-hots by comparison (no index checked on the
    host) and runs its f32 products in full f32, forward and backward: with
    TF32 allowed by the caller every matrix product of the forward and of
    the backward runs at "highest", the output and the gradients have the
    same bits as with the default, and the caller's setting is back
    afterwards."""
    model, params = _clustered_experts("phi3.5-moe-42b-a6.6b")
    pcfg = port_model("phi3.5-moe-42b-a6.6b", n_layers=2).cfg
    p = port_tf.layer_slice(_port_tree(params["blocks"]["mlp"]), 0)
    x0 = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 7, 128)).astype(np.float32))

    def run():
        x = x0.clone().requires_grad_()
        router = p["router"].clone().requires_grad_()
        out, aux = port_layers.moe_block({**p, "router": router}, x, pcfg)
        gx, gr = torch.autograd.grad((out * out).sum() + aux, (x, router))
        return out.detach(), gx, gr

    class Precisions(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "mm" in func.__name__:      # mm, bmm, addmm, baddbmm
                self.seen.append(torch.get_float32_matmul_precision())
            return func(*args, **(kwargs or {}))

    base = run()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with Precisions() as mode:
            again = run()
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    # router, dispatch, three expert and one combine product forward; their
    # input gradients backward (the dispatch tensor and the experts take none)
    assert len(mode.seen) >= 6 + 6 and set(mode.seen) == {"highest"}, mode.seen
    for a, b in zip(base, again):
        assert float(a.abs().max()) > 0 and torch.equal(a, b)


def test_clustered_linear_refuses_stacked_experts_naming_the_route():
    _, params = _clustered_experts("phi3.5-moe-42b-a6.6b")
    leaf = port_tf.layer_slice(_port_tree(params["blocks"]["mlp"]), 0)["w_up"]
    with pytest.raises(NotImplementedError, match="resolve_weight"):
        port_ops.clustered_linear(torch.zeros(2, 128), leaf)


# ---------------------------------------------------------------------------
# the forward, the paged step
# ---------------------------------------------------------------------------

VARIANTS = {"dense": None, "lcd_float": dict(act_scale=None), "lcd_quant": dict(act_scale=0.06)}


def _variant_params(arch, variant, seed=1):
    model, params = reference_model(arch, seed=seed, n_layers=2)
    params = _lively(params, 17)
    if VARIANTS[variant] is not None:
        params = cluster_moe(params, 4, smooth_seed=2, **VARIANTS[variant])
    return model, params


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_and_aux_equal_the_reference(arch, variant):
    """`Model.apply` on the same converted params and tokens (2 x 24: one
    group of 48, which drops tokens at reduced width) as the reference's:
    logits and the summed aux loss."""
    model, params = _variant_params(arch, variant)
    pmodel = port_model(arch, n_layers=2)
    tokens = np.random.default_rng(3).integers(0, model.cfg.vocab, (2, 24)).astype(np.int32)
    with lut_serving("interpret" if variant != "dense" else None):
        want, want_aux = jax.jit(model.apply)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = pmodel.apply(_port_tree(params), {"tokens": torch.from_numpy(tokens)})
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert_close(float(aux), float(want_aux), rtol=1e-5, what=f"{arch}/{variant} aux")
    assert_close(np_of(got), np.asarray(want), atol=2e-4, what=f"{arch}/{variant} logits")


def test_remat_keeps_the_moe_block_inside_and_changes_no_number(monkeypatch):
    """Under autograd with `cfg.remat` each layer (the MoE block inside)
    runs under a checkpoint; logits, aux and gradients (the router's and the
    experts' too) equal remat off."""
    _, params = _variant_params("phi3.5-moe-42b-a6.6b", "dense")
    params = _port_tree(params)
    base = port_model("phi3.5-moe-42b-a6.6b", n_layers=2).cfg
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, base.vocab, (2, 12))
                              .astype(np.int32))
    calls = []
    real = port_tf._remat_block
    monkeypatch.setattr(port_tf, "_remat_block", lambda *a: calls.append(1) or real(*a))
    runs = {}
    for remat in (False, True):
        var = {k: v.detach().requires_grad_(True) for k, v in params["blocks"]["mlp"].items()}
        p = {**params, "blocks": {**params["blocks"], "mlp": var}}
        logits, aux = get_model(dataclasses.replace(base, remat=remat)).apply(
            p, {"tokens": tokens})
        loss = logits.float().square().mean() + 0.01 * aux
        runs[remat] = (logits.detach(), aux.detach(), torch.autograd.grad(loss, list(var.values())))
    assert len(calls) == 2
    assert torch.equal(runs[True][1], runs[False][1])
    assert_close(np_of(runs[True][0]), np_of(runs[False][0]), rtol=1e-6, atol=1e-7,
                 what="remat logits")
    for a, b in zip(runs[True][2], runs[False][2]):
        assert float(b.abs().max()) > 0
        assert_close(np_of(a), np_of(b), rtol=1e-5, atol=1e-7, what="remat grads")


def _steps(cfg, S, T, rng):
    """Two prefill chunks (slot 1 idle throughout, ragged chunk lengths),
    then three decode steps."""
    n_first = np.array([T, 0, T - 3, 2][:S], np.int32)
    steps = [(rng.integers(0, cfg.vocab, (S, T)).astype(np.int32), n_first)]
    steps.append((rng.integers(0, cfg.vocab, (S, T)).astype(np.int32),
                  np.where(n_first > 0, T, 0).astype(np.int32)))
    for _ in range(3):
        steps.append((rng.integers(0, cfg.vocab, (S, 1)).astype(np.int32),
                      (n_first > 0).astype(np.int32)))
    return steps


STEP_CASES = [(v, "float") for v in VARIANTS] + [("dense", "int8"), ("lcd_float", "int8")]


@pytest.mark.parametrize("variant,kv_dtype", STEP_CASES, ids=lambda c: c)
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_logits_and_pools(arch, variant, kv_dtype):
    """Two prefill chunks and three decode steps of the port's paged step
    against the reference's on the same converted params and pools: the
    logits of the live slots and every pool tensor, after every step. All
    S * T tokens of a step, the idle slot's and the padding's too, share the
    routing, as in the reference.

    Over an int8 pool the two packages' f32 sums in another order can put a
    K / V element on the other side of an int8 rounding boundary, which
    moves the logits by far more than an f32 ulp. So the codes are held to
    one step on at most 0.1 % of the entries, and after every step the
    port's pools are set to the reference's: each step starts from the same
    pools and no flip carries into a later step. A slot whose blocks took a
    flipped code in this step is left out of this step's logit check (its
    logits read the flipped code); every other live slot's logits, and
    every step's scales, are held to the float standard. (Without the reset
    reduced llama4-scout with dense weights flipped one code of 24,576 at
    step 1; with it, no case here flips.)
    """
    model, params = _variant_params(arch, variant)
    cfg = model.cfg
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
        flipped = np.zeros(S, bool)
        for name, ref_pool in cache.items():
            ref_pool = np.asarray(ref_pool)
            port_pool = np_of(pcache[name])
            if ref_pool.dtype == np.int8:
                step = np.abs(port_pool.astype(np.int32) - ref_pool.astype(np.int32))
                assert step.max() <= 1 and (step > 0).mean() <= 1e-3, \
                    f"{name} pool codes, step {i}"
                blocks = np.nonzero(step.any(axis=(0, 2, 3, 4)))[0]   # (L, nb, bs, h, d)
                flipped |= np.isin(tables, blocks).any(axis=1)
            else:
                assert_close(port_pool, ref_pool, rtol=1e-6,
                             atol=1e-6 if "scale" in name else 1e-5,
                             what=f"{name} pool, step {i}")
            pcache[name].copy_(torch.from_numpy(ref_pool.copy()))
        got, want = np_of(got), np.asarray(want)
        assert_close(got[live & ~flipped], want[live & ~flipped], atol=2e-4,
                     what=f"{arch}/{variant}/{kv_dtype} logits, step {i}")
        lengths = lengths + n_new


# ---------------------------------------------------------------------------
# compression, the draft, one training step
# ---------------------------------------------------------------------------

def test_compress_model_leaves_the_experts_dense_as_the_reference():
    """`compress_model` on reduced phi3.5-moe with the default predicate
    (ndim 2 or 3 only): the attention clustered per layer slice with the
    reference's codes and packed bytes, the 4-D experts and the router dense
    and equal in both, and the same packed bytes."""
    model, dense = reference_model("phi3.5-moe-42b-a6.6b", seed=4, n_layers=2)
    pdense = _port_tree(dense)
    want = ref_api.compress_model(dense, target_centroids=8, nbits=4)
    got = port_api.compress_model(pdense, target_centroids=8, nbits=4)
    _assert_same_compression(got, want, "moe")
    assert sorted(got[1].bits_assignment) == sorted(
        f"['blocks']['attn']['{k}']" for k in ("wk", "wo", "wq", "wv"))
    for k in ("router",) + EXPERT_LEAVES:
        leaf = got[0]["blocks"]["mlp"][k]
        assert not is_clustered(leaf) and torch.equal(leaf, pdense["blocks"]["mlp"][k])
    assert port_cp.packed_weight_bytes(got[0]) == ref_cp.packed_weight_bytes(want[0])


def test_dequantize_and_draft_of_a_clustered_moe_equal_the_reference():
    """`dequantize_params` resolves the (L, E, ...) expert leaves of a
    clustered MoE (the layout `materialize_clustered` gives) to the
    reference's dense experts, layer by layer (exact): the reference's own
    `dequantize_params` vmaps over one leading axis only and refuses the
    (L, E) stack, so it is held per layer slice. `make_draft_params` of a
    target compressed as `compress_model` leaves it (attention clustered,
    experts dense) re-clusters the attention at 2 bits with the reference's
    codes and keeps the experts dense and equal, as the reference's draft
    does."""
    _, params = _clustered_experts("llama4-scout-17b-a16e")
    got = port_cp.dequantize_params(_port_tree(params))
    with pytest.raises(ValueError):
        ref_cp.dequantize_params(params)
    for l in range(2):
        want = to_numpy_tree(ref_cp.dequantize_params(
            jax.tree_util.tree_map(lambda a: a[l], params["blocks"]["mlp"],
                                   is_leaf=lambda x: x is None)))
        for k in EXPERT_LEAVES:
            assert_equal(np_of(got["blocks"]["mlp"][k][l]), want[k], f"dequantized {k}, layer {l}")
    _, dense = reference_model("llama4-scout-17b-a16e", seed=6, n_layers=2)
    target, _ = ref_api.compress_model(dense, target_centroids=8, nbits=4)
    port = _port_tree(target)
    ref_draft, ref_rep = ref_cp.make_draft_params(target, draft_centroids=4)
    draft, rep = port_cp.make_draft_params(port, draft_centroids=4)
    assert rep.bits_assignment == ref_rep.bits_assignment and len(rep.bits_assignment) == 4
    rd = to_numpy_tree(ref_draft)
    for k in ("wq", "wk", "wv", "wo"):
        assert_equal(np_of(draft["blocks"]["attn"][k].packed), rd["blocks"]["attn"][k]["packed"],
                     f"draft {k} packed")
    for k in ("router",) + EXPERT_LEAVES:
        assert not is_clustered(draft["blocks"]["mlp"][k])
        assert_equal(np_of(draft["blocks"]["mlp"][k]), rd["blocks"]["mlp"][k], f"draft {k}")
    assert port_cp.packed_weight_bytes(draft) == ref_cp.packed_weight_bytes(ref_draft)


def test_one_train_step_with_the_aux_loss_equals_the_reference():
    """One `build_train_step` step on reduced phi3.5-moe (dense, f32): loss,
    aux (non-zero, weighted 0.01 into the objective) and gradient norm equal
    the reference's jitted step, and every raw gradient, the router's and
    the experts' included, to 2e-6 of its leaf's largest, through each
    package's own autograd."""
    from repro.launch.mesh import make_host_mesh
    from repro.distributed.sharding import use_rules
    from repro.launch import steps as ref_steps
    from repro.models.registry import lm_loss as ref_lm_loss
    from repro.optim import compress as ref_compress
    from repro.optim import optimizer as ref_opt
    from repro_torch.launch import steps as port_steps
    from repro_torch.models.registry import lm_loss
    from repro_torch.optim import compress as port_compress
    from repro_torch.optim import optimizer as port_opt
    from repro_torch.tree import flatten_with_paths, leaves, unflatten

    rmodel, params = reference_model("phi3.5-moe-42b-a6.6b", seed=5, n_layers=2)
    pmodel = port_model("phi3.5-moe-42b-a6.6b", n_layers=2)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (4, 16)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
             "loss_mask": np.ones((4, 16), np.float32)}
    opt = ref_opt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with use_rules(make_host_mesh()):
        b = ref_steps.build_train_step(rmodel, ref_config.ShapeConfig("t", 16, 4, "train"), opt)
        fn = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
        _, _, _, want_m = fn(params, ref_opt.init_adam(params),
                          ref_compress.EFState(None), jb)
    pp = _port_tree(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    from repro_torch.distributed.sharding import use_rules as port_use_rules
    from repro_torch.launch.mesh import make_host_mesh as port_make_host_mesh
    with port_use_rules(port_make_host_mesh([torch.device("cpu")])):
        step = port_steps.build_train_step(pmodel, port_config.ShapeConfig("t", 16, 4, "train"),
                                           port_opt.OptConfig(**dataclasses.asdict(opt)))
    _, got_o, _, got_m = step(pp, port_opt.init_adam(pp), port_compress.EFState(None), tb)
    assert float(got_m["aux"]) > 0 and int(got_o.step) == 1
    for key in ("loss", "aux", "grad_norm"):
        assert float(got_m[key]) == pytest.approx(float(want_m[key]), rel=1e-5), key

    def ref_loss(p):
        logits, aux = rmodel.apply(p, jb)
        return ref_lm_loss(logits, jb["targets"], jb["loss_mask"], 512) + 0.01 * aux
    ref_grads = jax.tree_util.tree_leaves(jax.grad(ref_loss)(params))
    var = [x.detach().requires_grad_(True) for x in leaves(pp)]
    logits, aux = pmodel.apply(unflatten(pp, var), tb)
    grads = torch.autograd.grad(lm_loss(logits, tb["targets"], tb["loss_mask"], 512)
                                + 0.01 * aux, var)
    for g, w in zip(grads, ref_grads):
        w = np.asarray(w)
        assert_close(np_of(g), w, atol=2e-6 * float(np.abs(w).max()), what="raw gradient")
    paths = [p for p, _ in flatten_with_paths(pp)]
    assert float(grads[paths.index("['blocks']['mlp']['router']")].abs().max()) > 0
