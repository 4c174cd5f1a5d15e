"""The slot-state families served on a (data, model) mesh of repeated CPU
devices: rwkv6-1.6b and gla-1.3b (per-slot recurrent state), zamba2-1.2b
(mamba state and its shared sites' paged pools) and whisper-large-v3 (the
decoder's self K/V and the encoder's cross K/V, per slot), at `reduced()`.

LCD weights, quantile-clustered from the reference's dense init, float and
quantized Eq. 11 transform (gla's gate LoRA dense, as in the reference), on
1 x 2, 2 x 1 and 2 x 2: the tokens and every step's logits are
`torch.equal` to the port's 1 x 1 engine (held to the reference's engine by
tests/test_torch_recurrent_engine.py and test_torch_whisper_engine.py), and
each model rank's part of every state leaf equals the 1 x 1 state's slice
of its heads (its inner channels for zamba2's conv state). Then preemption
on 2 x 1 (snapshots; zamba2 by recompute) and whisper's encode writing
every rank's cross-K/V part."""
import numpy as np
import pytest
import torch

from repro_torch.core.api import is_clustered
from repro_torch.distributed.placement import MeshTree
from repro_torch.distributed.sharding import Sharded
from repro_torch.launch import engine as port_engine
from repro_torch.launch.mesh import make_mesh

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import with_act_scale
from test_torch_mesh_engine import _Logits, _same_logits
from test_torch_recurrent import _port_tree, cluster_family, pair
from test_torch_whisper import _frames
from test_torch_whisper import pair as whisper_pair

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

CPU = torch.device("cpu")
ARCHS = ("rwkv6-1.6b", "gla-1.3b", "zamba2-1.2b", "whisper-large-v3")
MESHES = [(1, 2), (2, 1), (2, 2)]
MESH_IDS = [f"{d}x{m}" for d, m in MESHES]
ECFG = dict(num_slots=4, block_size=4, num_blocks=40, max_blocks_per_slot=10,
            prefill_chunk=8)


def _mesh(d, m):
    return make_mesh((d, m), ("data", "model"), [CPU] * (d * m))


def _quantized(tree):
    if is_clustered(tree):
        return with_act_scale(tree, 0.05)
    if isinstance(tree, dict):
        return {k: _quantized(v) for k, v in tree.items()}
    return tree


_MODELS = {}


def _model(arch, variant="float"):
    """(port model, LCD params): 4-bit, smoothing vectors in [0.5, 1.5],
    the float transform, or the quantized one (act_scale 0.05)."""
    if (arch, variant) not in _MODELS:
        if arch == "whisper-large-v3":
            _, _, model, params = whisper_pair(seed=3, variant="lcd_float")
        else:
            rmodel, dense, model = pair(arch, seed=3)
            params = _port_tree(cluster_family(rmodel, dense, 4, smooth_seed=4))
        _MODELS[arch, variant] = (model, _quantized(params) if variant == "quant" else params)
    return _MODELS[arch, variant]


def _requests(model, n=3, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, model.cfg.vocab, int(rng.integers(3, 14))).astype(np.int32)
        frames = _frames(model.cfg, 1, 50 + i) if model.cfg.is_encdec else None
        out.append((prompt, frames))
    return out


def _engine(model, params, mesh=None, **kw):
    eng = port_engine.ServingEngine(model, params, port_engine.EngineConfig(**{**ECFG, **kw}),
                                    mesh=mesh, device="cpu")
    eng.model = _Logits(model)
    return eng


def _whole_state(eng):
    """{name: the slot state leaf, its parts concatenated on their cut dim}
    and {name: the cut dim} (None: whole)."""
    state = eng.caches["slot"]
    if not isinstance(state, MeshTree):
        return dict(state), {}
    leaves = state.views[0]
    return ({name: leaf.parts[0] if leaf.dim is None else torch.cat(leaf.parts, leaf.dim)
             for name, leaf in leaves.items()}, {name: leaf.dim for name, leaf in leaves.items()})


_RUNS = {}


def _run(arch, variant, shape=None):
    """The requests through one engine on `shape` (None: one device), made
    once: (tokens, every step's logits, the engine)."""
    key = (arch, variant, shape)
    if key not in _RUNS:
        model, params = _model(arch, variant)
        eng = _engine(model, params, None if shape is None else _mesh(*shape))
        reqs = [eng.submit(p, 6, frames=f) for p, f in _requests(model)]
        eng.run()
        eng.assert_bounded_traces()
        _RUNS[key] = ([list(r.out_tokens) for r in reqs], eng.model.logits, eng)
    return _RUNS[key]


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("variant", ["float", "quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_tokens_and_logits_equal_one_device(arch, variant, shape):
    want, want_logits, _ = _run(arch, variant)
    got, logits, eng = _run(arch, variant, shape)
    assert eng.mesh.shape == {"data": shape[0], "model": shape[1]}
    assert got == want
    assert _same_logits(logits, want_logits)
    assert len({tuple(t) for t in want}) > 1


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_heads_of_the_state(arch, shape):
    """After the same run, every model rank's part of every state leaf (and
    of zamba2's pools) is the 1 x 1 engine's leaf sliced to its heads; the
    data ranks hold the same tensors; the parts' bytes add up to the whole."""
    _, _, one = _run(arch, "float")
    _, _, eng = _run(arch, "float", shape)
    m = shape[1]
    cut = {"rwkv6-1.6b": {"wkv": 2}, "gla-1.3b": {"s": 2},
           "zamba2-1.2b": {"ssm": 2, "conv": 3},
           "whisper-large-v3": {"k": 3, "v": 3, "ck": 3, "cv": 3}}[arch]
    for kind, tree in eng.caches.items():
        want = one.caches[kind]
        for name, leaf in tree.views[0].items():
            assert isinstance(leaf, Sharded) and len(leaf.parts) == m
            assert all(a is b for a, b in zip(leaf.parts, tree.views[-1][name].parts))
            dim = cut.get(name, 3 if kind == "paged" else None)
            assert leaf.dim == (dim if m > 1 else None), (kind, name)
            if leaf.dim is None:
                assert torch.equal(leaf.parts[0], want[name])
                continue
            size = want[name].shape[dim] // m
            for r, part in enumerate(leaf.parts):
                assert torch.equal(part, want[name].narrow(dim, r * size, size)), (name, r)
            assert sum(p.numel() for p in leaf.parts) == want[name].numel()


@pytest.mark.parametrize("arch", ARCHS)
def test_preempted_equals_unpreempted_on_2x1(arch):
    """On 2 x 1, one running request preempted after its second token and
    re-admitted: every request's tokens equal the unpreempted run's. rwkv6,
    gla and whisper resume from a snapshot of their slot's rows (no token
    fed twice, whisper's encoder run once a request), zamba2 recomputes."""
    model, params = _model(arch)
    reqs_in = _requests(model, n=3, seed=11)

    def drive(preempt):
        eng = _engine(model, params, _mesh(2, 1))
        fed = [0]
        inner = eng._model_step

        def counting(tokens, n_new):
            fed[0] += int(n_new.sum())
            return inner(tokens, n_new)
        eng._model_step = counting
        reqs = [eng.submit(p, 7, frames=f) for p, f in reqs_in]
        done = False
        while eng.busy:
            if preempt and not done and len(reqs[1].out_tokens) >= 2 and reqs[1].state == "running":
                eng.preempt(reqs[1])
                done = True
            eng.step()
        return [list(r.out_tokens) for r in reqs], dict(eng.traces), fed[0], done

    want, _, fed_want, _ = drive(False)
    got, traces, fed, done = drive(True)
    assert done and got == want
    snap = model.seq_caches["slot"].snapshot and "paged" not in model.seq_caches
    assert traces.get("snapshot", 0) == traces.get("restore", 0) == (1 if snap else 0)
    assert (fed == fed_want) if snap else (fed > fed_want)
    if model.cfg.is_encdec:
        assert traces["encode"] == len(reqs_in)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
def test_whisper_encode_fills_every_ranks_cross_kv(shape):
    """Admission encodes a request once into its slot: on the mesh each
    model rank's part of "ck" / "cv" holds that request's cross K/V of its
    kv heads, the one-device `encode_prefill` sliced; the other slots' rows
    stay zero."""
    model, params = _model("whisper-large-v3")
    eng = _engine(model, params, _mesh(*shape))
    (prompt, frames), = _requests(model, n=1, seed=13)
    eng.submit(prompt, 2, frames=frames)
    eng._admit()
    slot = next(s for s, r in enumerate(eng.slots) if r is not None)
    assert eng.traces["encode"] == 1
    ck, cv = model.encode_prefill(params, torch.from_numpy(frames))
    m = shape[1]
    for name, want in (("ck", ck), ("cv", cv)):
        leaf = eng.caches["slot"].views[0][name]
        assert leaf.dim == 3 and len(leaf.parts) == m
        size = want.shape[2] // m
        for r, part in enumerate(leaf.parts):
            assert torch.equal(part[:, slot], want.narrow(2, r * size, size))
            others = [s for s in range(ECFG["num_slots"]) if s != slot]
            assert not part[:, others].any()
