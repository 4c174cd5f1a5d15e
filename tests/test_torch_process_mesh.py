"""The serving engine on a process mesh: one torch.distributed process per
(data, model) coordinate, gloo on the CPU, each process holding only its
own shards.

The contract is the one-process mesh's, in bits: on (1, 2), (2, 1) and
(2, 2) every process's tokens and every step's logits are `torch.equal` to
the one-process `[cpu] x n` mesh engine of the same shape (itself held to
1 x 1 and the reference by tests/test_torch_mesh_engine.py), and so is each
process's pool replica, float and int8 (every data rank's K / V writes reach
every replica). Models: the reference's `tiny-tp` (dense), `reduced()`
llama2-7b with LCD weights (float and quantized transform, fused QKV and
gate+up; per projection too) and `reduced()` paligemma-3b (the vlm family; one kv head, so the
pool stays whole on the model axis); the priority scheduler, chunked
prefill and the prefix cache on one engine. Then a prefix block written by a
data-rank-0 slot and matched into a slot of another data rank (tokens =
cache off), the bytes a process holds, rank 0's `tiny-tp` tokens against the
JAX reference engine, the refusals (speculative, MoE, recurrent, hybrid,
audio, training), the collectives' rank order and byte counts on plain
tensors, the lockstep check, and `run_on_processes` failing on a child's
error or a timeout.

The processes are spawned once per world size in a module-scoped fixture:
two processes run the (1, 2) and (2, 1) meshes (a second
`init_process_mesh` over the same processes), four the (2, 2) mesh; the test
functions read their results. Every spawn has a timeout."""
import time

import jax
import pytest
import torch

import _process_mesh_drives as drives
from repro.launch import engine as ref_engine
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.registry import get_model as ref_get_model
from repro_torch.convert import from_reference
from repro_torch.core.api import is_clustered
from repro_torch.launch import engine as port_engine
from repro_torch.launch.mesh import make_mesh, run_on_processes
from repro_torch.models.config import ModelConfig, get_config, reduced
from repro_torch.models.registry import get_model

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import cluster_params, port_model, reference_model, to_numpy_tree

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

CPU = torch.device("cpu")
# the mesh shapes each world's processes run, the first made by the spawn
WORLDS = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
SHAPES = [s for shapes in WORLDS.values() for s in shapes]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]
NAMES = ["tiny", "llama_float", "llama_quant", "llama_unfused", "pali"]
TINY = dict(arch_id="tiny-tp", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, head_dim=32, dtype="float32")
SPAWN_TIMEOUT_S = 300
REFUSED = {"speculative": "A7.4", "moe": "A7.3", "recurrent": "A7.3", "hybrid": "A7.3",
           "audio": "A7.3", "training": "A7.5"}


@pytest.fixture(scope="module")
def models():
    """name -> (port model, port params on the CPU, reference model,
    reference params): tiny-tp dense and reduced llama2-7b LCD (float /
    quantized transform, fused; the quantized weights per projection too),
    the same weights in both packages; reduced paligemma-3b dense from the
    port's own init (no reference run)."""
    out = {}
    rmodel = ref_get_model(RefModelConfig(**TINY))
    rparams = rmodel.init(jax.random.key(0))
    out["tiny"] = (get_model(ModelConfig(**TINY)),
                   from_reference(to_numpy_tree(rparams), device="cpu"), rmodel, rparams)
    rmodel, dense = reference_model("llama2-7b", seed=2)
    pmodel = port_model("llama2-7b", fused_projections=True)
    for name, act in (("llama_float", None), ("llama_quant", 0.05)):
        rp = cluster_params(dense, 4, act_scale=act, smooth_seed=5)
        out[name] = (pmodel, from_reference(to_numpy_tree(rp), device="cpu"), rmodel, rp)
    out["llama_unfused"] = (port_model("llama2-7b"),) + out["llama_quant"][1:]
    pali = get_model(reduced(get_config("paligemma-3b"), dtype="float32"))
    out["pali"] = (pali, pali.init(torch.Generator().manual_seed(3), device="cpu"), None,
                   None)
    return out


@pytest.fixture(scope="module")
def smooth(models):
    model, params, _, _ = models["tiny"]
    return port_engine.calibrate_kv_smooth(model, params, n_tokens=16, batch=2)


@pytest.fixture(scope="module")
def runs(models, smooth):
    """shape -> every process's results of `drives.drive` (rank order),
    "refusals" -> the world-2 processes' refusal messages, and per world
    size ("built", n) / ("weights_differ", n) -> every process's
    `build_engine` drives under its process group."""
    payload = {name: (m.cfg, p) for name, (m, p, _, _) in models.items()}
    extra = dict(int8=("tiny", smooth), prefix="llama_float", sched="llama_quant",
                 built="llama_float")
    out = {}
    for world, shapes in WORLDS.items():
        results = run_on_processes(drives.drive, shapes[0], backend="gloo",
                                   devices=[CPU] * world, timeout_s=SPAWN_TIMEOUT_S,
                                   args=(payload, shapes, extra))
        for shape in shapes:
            out[shape] = [r["x".join(map(str, shape))] for r in results]
        out.setdefault("refusals", [r["refusals"] for r in results])
        out[("built", world)] = [r["built"] for r in results]
        out[("weights_differ", world)] = [r["weights_differ"] for r in results]
    return out


_ONE_PROCESS = {}


def _one_process(models, smooth, shape):
    """The same drives on the one-process [cpu] x n mesh of `shape`, run once."""
    if shape not in _ONE_PROCESS:
        mesh = make_mesh(shape, ("data", "model"), [CPU] * (shape[0] * shape[1]))
        row = {name: drives.serve(m, p, mesh) for name, (m, p, _, _) in models.items()}
        m, p, _, _ = models["tiny"]
        row["int8"] = drives.serve(m, p, mesh, kv_dtype="int8", kv_smooth=smooth)
        m, p, _, _ = models["llama_quant"]
        row["sched"] = drives.serve(m, p, mesh, n=6, tenants=True, **drives.SCHED)
        if shape[0] > 1:
            m, p, _, _ = models["llama_float"]
            row["prefix"] = drives.prefix_across_data_ranks(m, p, mesh, True)
        _ONE_PROCESS[shape] = row
    return _ONE_PROCESS[shape]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _pools_equal(got, want, model_rank):
    """A process's pool (one part a leaf) against the one-process mesh's
    part of its model rank."""
    return set(got) == set(want) and all(
        torch.equal(got[name][0], want[name][model_rank]) for name in want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_tokens_and_logits_equal_the_one_process_mesh(models, smooth, runs, shape, name):
    want = _one_process(models, smooth, shape)[name]
    assert len(runs[shape]) == shape[0] * shape[1]
    for r in runs[shape]:
        got = r[name]
        assert got["tokens"] == want["tokens"], r["coord"]
        assert _same(got["logits"], want["logits"]), r["coord"]
        assert got["eager_reason"].startswith("cpu")


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_production_features_equal_the_one_process_mesh(models, smooth, runs, shape):
    """The priority scheduler (weighted tenants under a token budget),
    chunked-prefill admission and the prefix cache on one engine: tokens,
    every step's logits and the pool replicas of the one-process mesh."""
    want = _one_process(models, smooth, shape)["sched"]
    for r in runs[shape]:
        got = r["sched"]
        assert got["tokens"] == want["tokens"] and _same(got["logits"], want["logits"])
        assert _pools_equal(got["pool"], want["pool"], r["coord"]["model"])


@pytest.mark.parametrize("kind", ["float", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_pool_replicas_equal_the_one_process_pool(models, smooth, runs, shape, kind):
    """Every process's pool replica after the drive == the one-process
    pool's part of its model rank (the data ranks' replicas included):
    float pools of every model, and the int8 pool (codes, scales, smoothing
    vectors), whose tokens and logits are held too."""
    one = _one_process(models, smooth, shape)
    for r in runs[shape]:
        m = r["coord"]["model"]
        if kind == "int8":
            got, want = r["int8"], one["int8"]
            assert set(got["pool"]) >= {"k_scale", "v_scale", "k_smooth", "v_smooth"}
            assert got["tokens"] == want["tokens"] and _same(got["logits"], want["logits"])
            assert _pools_equal(got["pool"], want["pool"], m), r["coord"]
        else:
            for name in NAMES:
                assert _pools_equal(r[name]["pool"], one[name]["pool"], m), (name, r["coord"])


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_a_prefix_block_matched_across_data_ranks(models, smooth, runs, shape):
    """B shares A's two cached blocks, which a data-rank-0 slot wrote, from a
    slot of the last data rank: the same tokens as the cache-off engine, and
    the tokens, logits and pool of the one-process mesh with the cache on."""
    want = _one_process(models, smooth, shape)["prefix"]
    for r in runs[shape]:
        on, off = r["prefix"][True], r["prefix"][False]
        assert on["slots"] == (0, 2, 1) and on["cached_tokens"] >= 8
        assert on["tokens"] == off["tokens"] == want["tokens"]
        assert _same(on["logits"], want["logits"])
        assert _pools_equal(on["pool"], want["pool"], r["coord"]["model"])


def _lut_bytes(params) -> int:
    """Bytes of every clustered leaf's codes and packed codes."""
    if is_clustered(params):
        return sum(getattr(params, f).numel() * getattr(params, f).element_size()
                   for f in ("codes", "packed") if getattr(params, f) is not None)
    if isinstance(params, dict):
        return sum(_lut_bytes(v) for v in params.values())
    return 0


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_each_process_holds_only_its_shards(models, runs, shape):
    """LCD llama2-7b: a process's params hold 1/m of the LUT codes (every
    projection cut by its output columns) and every other tensor whole (the
    vocab tables, the norms, the codebooks and smoothing vectors), and
    equal what a model rank holds on the one-process mesh."""
    model, params, _, _ = models["llama_float"]
    whole, lut = port_engine._tree_bytes(params), _lut_bytes(params)
    mp = shape[1]
    mesh = make_mesh(shape, ("data", "model"), [CPU] * (shape[0] * mp))
    one = port_engine.ServingEngine(model, params, port_engine.EngineConfig(**drives.ECFG),
                                    mesh=mesh, device="cpu").params
    for r in runs[shape]:
        held = r["llama_float"]["param_bytes"]
        assert held == whole - lut + lut // mp
        assert held == port_engine._tree_bytes(one.rank_tree(r["coord"]["model"]))
        if mp > 1:
            assert held < whole


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_rank0_tiny_tokens_equal_the_reference_engine(models, runs, shape):
    model, _, rmodel, rparams = models["tiny"]
    if "ref" not in _ONE_PROCESS:
        ref = ref_engine.ServingEngine(rmodel, rparams,
                                       ref_engine.EngineConfig(**drives.ECFG))
        reqs = [ref.submit(p, 8) for p in drives.prompts(model.cfg.vocab)]
        ref.run()
        _ONE_PROCESS["ref"] = [list(r.out_tokens) for r in reqs]
    assert runs[shape][0]["tiny"]["tokens"] == _ONE_PROCESS["ref"]


# build_engine under a process group: per world size, the knob cases (one
# per mesh shape its processes run) and the layout search
BUILT = [(w, "x".join(map(str, s))) for w, shapes in WORLDS.items() for s in shapes] + [
    (w, "search") for w in WORLDS]


@pytest.mark.parametrize("world,case", BUILT, ids=[f"world{w}-{c}" for w, c in BUILT])
def test_build_engine_under_a_process_group(models, smooth, runs, world, case):
    """torchrun's entry point without torchrun: `build_engine` in processes
    that already hold a gloo process group serves on a process mesh of the
    shape its knobs give (the other factor derived from the world size) or
    the layout search chooses over the world's processes, and its tokens
    and every step's logits equal the one-process mesh's of that shape."""
    for r in runs[("built", world)]:
        got = r[case]
        assert got["process_mesh"] and got["world"] == world
        key = "x".join(map(str, got["shape"]))
        if case == "search":
            assert got["chosen"] == key
        else:
            assert key == case and got["chosen"] is None
        want = _one_process(models, smooth, got["shape"])["llama_float"]
        assert got["tokens"] == want["tokens"] and _same(got["logits"], want["logits"])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_build_engine_refuses_weights_that_differ_across_processes(runs, world):
    """The last process's final norm differs from the others' in one
    element: `build_engine` raises on every process, naming that rank."""
    for msg in runs[("weights_differ", world)]:
        assert msg is not None and f"rank(s) [{world - 1}] differ from rank 0's" in msg


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_a_process_mesh_refuses(runs, what):
    """Speculative rounds, the MoE, recurrent, hybrid and audio families and
    training raise NotImplementedError on a process mesh, naming the
    ROADMAP item each waits for."""
    for messages in runs["refusals"]:
        assert "process mesh" in messages[what]
        assert f"ROADMAP {REFUSED[what]}" in messages[what]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_collectives_rank_order_and_bytes(runs, shape):
    """all_gather of a tensor holding the rank, over each axis group, on
    dims 0 and 1: the members' tensors in the group's rank order; a
    broadcast from the group's last member; the calls and bytes counted
    (none for a group of one)."""
    for r in runs[shape]:
        c = r["collectives"]
        calls = nbytes = bcasts = 0
        for axis in ("data", "model"):
            ranks = c[axis]["ranks"]
            parts = [torch.full((2, 3), float(k), dtype=torch.bfloat16) for k in ranks]
            assert torch.equal(c[axis]["dim0"], torch.cat(parts, 0))
            assert torch.equal(c[axis]["dim1"], torch.cat(parts, 1))
            assert c[axis]["bcast"].tolist() == [ranks[-1]]
            if len(ranks) > 1:
                calls, nbytes, bcasts = calls + 2, nbytes + 2 * 12 * len(ranks), bcasts + 1
        assert c["counts"]["all_gather"] == {"calls": calls, "bytes": nbytes,
                                             "staged_calls": 0}
        assert c["counts"]["broadcast"] == {"calls": bcasts, "bytes": 8 * bcasts,
                                            "staged_calls": 0}


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_the_lockstep_check_raises_where_a_process_disagrees(runs, shape):
    """The last rank's tokens differ from rank 0's broadcast: it raises,
    every other process agrees with rank 0."""
    msgs = [r["lockstep"] for r in runs[shape]]
    assert all(m is None for m in msgs[:-1])
    assert "out of lockstep" in msgs[-1] and "differ from rank 0's" in msgs[-1]


@pytest.mark.parametrize("case", ["error", "timeout"])
def test_run_on_processes_fails_and_stops_every_child(case):
    """A child's exception fails the call with its traceback; a child that
    does not finish in time is killed and fails it, well before it would
    have ended."""
    t0 = time.monotonic()
    if case == "error":
        with pytest.raises(RuntimeError, match="(?s)rank 1 of .* failed.*on purpose"):
            run_on_processes(drives.fails_on_rank_1, (1, 2), backend="gloo", devices=[CPU] * 2,
                             timeout_s=60)
    else:
        # rank 0 returns at once, but under a loaded host it may not have
        # started within the 3 s either
        with pytest.raises(TimeoutError,
                           match=r"rank\(s\) \[(0, )?1\] of \(2, 1\) did not finish within 3 s"):
            run_on_processes(drives.hangs_on_rank_1, (2, 1), backend="gloo", devices=[CPU] * 2,
                             timeout_s=3)
    assert time.monotonic() - t0 < 60
