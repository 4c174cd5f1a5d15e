"""The MoE family served on a (data, model) mesh of repeated CPU devices.

Reduced phi3.5-moe-42b-a6.6b (top-2) and llama4-scout-17b-a16e (top-1), 2
layers, 4 experts, every projection and expert clustered by
`materialize_clustered`, the float and the quantized Eq. 11 transform, on
1 x 2, 2 x 1, 2 x 2 and 1 x 4: the tokens and every step's logits are
`torch.equal` to the port's 1 x 1 engine, whose tokens
`tests/test_torch_moe_engine.py` holds to the reference's engine. An MoE
layer routes every row of a step together under a capacity, so the mesh
step gathers the data ranks' rows before the layer: a case with capacity
drops shows the drops and that routing each data rank's rows alone would
give another answer. Then `moe_block` on a cut stack against the whole, the
packed bytes a rank holds, and speculation on 1 x 2 against its 1 x 1
engine."""
import pytest
import torch

from repro_torch.core.api import is_clustered
from repro_torch.core.clustered_params import make_draft_params, materialize_clustered
from repro_torch.distributed import placement
from repro_torch.distributed.layout import SERVE_RULES, serving_names
from repro_torch.distributed.sharding import Sharded, auto_shard, use_rules
from repro_torch.launch import engine as port_engine
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers
from repro_torch.models.transformer import layer_slice

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import port_model, with_act_scale
from test_torch_mesh_engine import _Logits, _prompts, _same_logits

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

CPU = torch.device("cpu")
PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
MESH_IDS = [f"{d}x{m}" for d, m in MESHES]
EXPERTS = ("w_gate", "w_up", "w_down")
ECFG = dict(num_slots=4, block_size=4, num_blocks=40, max_blocks_per_slot=10, prefill_chunk=8)


def _mesh(d, m):
    return make_mesh((d, m), ("data", "model"), [CPU] * (d * m))


def _quantized(tree):
    """Every clustered leaf with the quantized Eq. 11 transform armed."""
    if is_clustered(tree):
        return with_act_scale(tree, 0.05)
    if isinstance(tree, dict):
        return {k: _quantized(v) for k, v in tree.items()}
    return tree


_MODELS = {}


def _model(arch, variant="float"):
    """(model, params): 2 layers, fused QKV, every eligible leaf and every
    expert clustered (random valid codes, unit smoothing), the router drawn
    20x materialize_clustered's scale so that each token has a clear top-k."""
    if (arch, variant) not in _MODELS:
        model = port_model(arch, n_layers=2, fused_projections=True)
        params = materialize_clustered(model, torch.Generator().manual_seed(3), device="cpu")
        mlp = params["blocks"]["mlp"]
        mlp["router"] = mlp["router"] * 20.0
        assert all(is_clustered(mlp[k]) for k in EXPERTS)
        _MODELS[arch, variant] = (model, _quantized(params) if variant == "quant" else params)
    return _MODELS[arch, variant]


def _serve(model, params, mesh=None, prompts=None, gen=6, **kw):
    """The prompts through one engine; (tokens per request, every step's
    logits, the engine)."""
    eng = port_engine.ServingEngine(model, params, port_engine.EngineConfig(**{**ECFG, **kw}),
                                    mesh=mesh, device="cpu")
    eng.model = _Logits(model)
    reqs = [eng.submit(p, gen) for p in (prompts or _prompts(vocab=model.cfg.vocab))]
    eng.run()
    eng.assert_bounded_traces()
    return [list(r.out_tokens) for r in reqs], eng.model.logits, eng


_ONE = {}


def _one_device(arch, variant):
    if (arch, variant) not in _ONE:
        _ONE[arch, variant] = _serve(*_model(arch, variant))[:2]
    return _ONE[arch, variant]


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("variant", ["float", "quant"])
@pytest.mark.parametrize("arch", [PHI, SCOUT])
def test_mesh_tokens_and_logits_equal_one_device(arch, variant, shape):
    model, params = _model(arch, variant)
    want, want_logits = _one_device(arch, variant)
    got, logits, eng = _serve(model, params, _mesh(*shape))
    assert eng.mesh.shape == {"data": shape[0], "model": shape[1]}
    assert got == want
    assert _same_logits(logits, want_logits)
    assert len({tuple(t) for t in want}) > 1


class _Drops:
    """`layers.moe_routing` with every call's dropped (token, top-k) pairs
    counted."""

    def __init__(self, monkeypatch):
        self.calls, self.dropped = 0, 0
        inner = layers.moe_routing

        def counting(router, xt, n_experts, topk):
            r = inner(router, xt, n_experts, topk)
            self.calls += 1
            self.dropped += int(xt.shape[0] * xt.shape[1] * topk - r.dispatch.sum().item())
            return r
        monkeypatch.setattr(layers, "moe_routing", counting)


@pytest.mark.parametrize("arch", [PHI, SCOUT])
def test_capacity_drops_route_the_whole_step_on_2x1(arch, monkeypatch):
    """Wide prefill windows with idle slots (their pad rows all route alike)
    make the capacity drop tokens: the drops happen on 1 x 1, and 2 x 1,
    whose MoE layer routes the two data ranks' gathered rows once, still
    equals it. Routing each data rank's rows alone (its own groups and
    capacity) gives that layer another output."""
    model, params = _model(arch)
    kw = dict(prefill_chunk=16, max_blocks_per_slot=12, num_blocks=48)
    prompts = _prompts(n=3, vocab=model.cfg.vocab)
    drops = _Drops(monkeypatch)
    want, want_logits, _ = _serve(model, params, prompts=prompts, **kw)
    assert drops.dropped > 0, "the case must drop tokens"
    got, logits, _ = _serve(model, params, _mesh(2, 1), prompts=prompts, **kw)
    assert got == want and _same_logits(logits, want_logits)
    p = layer_slice(params["blocks"], 0)["mlp"]
    x = torch.randn(4, 16, model.cfg.d_model, generator=torch.Generator().manual_seed(4))
    x[1:] = x[1:2, :1]                    # three idle slots' identical pad rows
    whole, _ = layers.moe_block(p, x, model.cfg)
    per_rank = torch.cat([layers.moe_block(p, x[:2], model.cfg)[0],
                          layers.moe_block(p, x[2:], model.cfg)[0]])
    assert not torch.equal(whole, per_rank)


def _cut(params, m):
    """The serving placement of `params` on a 1 x m mesh (data rank 0's tree)."""
    mesh = _mesh(1, m)
    with use_rules(mesh, SERVE_RULES, fsdp=False):
        return placement.place(params, auto_shard(params, serving_names(_model(PHI)[0])),
                               mesh).views[0]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("variant", ["float", "quant"])
def test_moe_block_on_a_cut_stack_equals_the_whole(variant, m):
    """`moe_block` with its experts cut in m parts (E/m a rank: each rank
    resolves and runs its own, their outputs gathered before the combine)
    gives the whole stack's bits, drops included; so does one expert's
    SwiGLU alone against its slice of the whole."""
    model, params = _model(PHI, variant)
    cut = _cut(params, m)
    x = torch.randn(4, 16, model.cfg.d_model, generator=torch.Generator().manual_seed(5))
    x[2:] = x[2:3, :1]
    for l in range(model.cfg.n_layers):
        p, pc = layer_slice(params["blocks"], l)["mlp"], layer_slice(cut["blocks"], l)["mlp"]
        assert isinstance(pc["w_gate"], Sharded) and pc["w_gate"].dim == 0
        assert torch.equal(layers.moe_block(pc, x, model.cfg)[0],
                           layers.moe_block(p, x, model.cfg)[0])
        xe = torch.randn(4, 1, 8, model.cfg.d_model, generator=torch.Generator().manual_seed(l))
        full = layers._expert_swiglu(xe, *(p[k] for k in EXPERTS))
        per = 4 // m
        for r in range(m):
            got = layers._expert_swiglu(xe[r * per:(r + 1) * per],
                                        *(pc[k].parts[r] for k in EXPERTS))
            assert torch.equal(got, full[r * per:(r + 1) * per])


@pytest.mark.parametrize("m", [2, 4, 8])
def test_each_rank_holds_its_experts(m):
    """On 1 x m each model rank holds E/m experts of every stacked leaf: 1/m
    of the packed bytes, and the codebooks, smoothing vectors and scales of
    those experts (the experts' slice of every field); at 8 ranks the 4
    experts fall back to whole, as the reference's rules give, and no rank
    cuts them on `ff` either."""
    model, params = _model(SCOUT, "quant")
    eng = port_engine.ServingEngine(model, params, mesh=_mesh(1, m), device="cpu")
    mlp = eng.params.views[0]["blocks"]["mlp"]
    for k in EXPERTS:
        whole = params["blocks"]["mlp"][k]
        if m == 8:
            assert not isinstance(mlp[k], Sharded) and mlp[k].codes is whole.codes
            continue
        leaf = mlp[k]
        assert isinstance(leaf, Sharded) and leaf.dim == 1 and len(leaf.parts) == m
        per = 4 // m
        for r, part in enumerate(leaf.parts):
            assert part.codes.numel() * m == whole.codes.numel()
            for f in ("codes", "codebook", "smooth", "inv_scale", "act_scale"):
                assert torch.equal(getattr(part, f), getattr(whole, f)[:, r * per:(r + 1) * per])


def test_speculative_on_1x2_equals_its_one_device_engine():
    """Speculative decoding (k = 3) of phi3.5-moe on 1 x 2 against the same
    engine on one device: tokens and every step's and verify's logits. The
    target's experts stay dense, as `compress_model` leaves them, and the
    2-bit draft re-clusters the attention."""
    model, params = _model(PHI)
    mlp = params["blocks"]["mlp"]
    dense = {**params, "blocks": {**params["blocks"], "mlp": {
        "router": mlp["router"], **{k: layers.resolve_weight(mlp[k], torch.float32)
                                     for k in EXPERTS}}}}
    draft, _ = make_draft_params(dense, draft_centroids=4)
    kw = dict(speculative_k=3, max_blocks_per_slot=12, num_blocks=48)

    def run(mesh):
        eng = port_engine.ServingEngine(model, dense, port_engine.EngineConfig(**{**ECFG, **kw}),
                                        mesh=mesh, device="cpu", draft_params=draft)
        eng.model = _Logits(model)
        reqs = [eng.submit(p, 6) for p in _prompts(vocab=model.cfg.vocab)]
        eng.run()
        eng.assert_bounded_traces()
        return [list(r.out_tokens) for r in reqs], eng.model.logits, eng

    want, want_logits, one = run(None)
    got, logits, eng = run(_mesh(1, 2))
    assert got == want and _same_logits(logits, want_logits)
    assert eng.spec_rounds == one.spec_rounds > 0
    assert isinstance(eng.draft_params, placement.MeshTree)
