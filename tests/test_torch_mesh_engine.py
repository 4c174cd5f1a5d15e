"""The serving engine on a (data, model) mesh of repeated CPU devices.

The reference's contract (`tests/test_sharded_serving.py`): tokens are
identical on every mesh factorization, and weights are really sharded. The
port's is stricter, bits: at 1 x 2, 2 x 1, 2 x 2, 1 x 4 and 2 x 4 the tokens
AND every step's logits are `torch.equal` to the port's 1 x 1 engine, whose
tokens equal the reference's 1 x 1 engine. Models: the reference's `tiny-tp`
config (2 kv heads: the pool takes the divisibility fallback at model 4 and
8; head_dim 32 here, where the reference's is 16, because the port's B5
takes head dims in multiples of 32) with dense weights, and a `reduced()`
llama2-7b with LCD weights, float and quantized Eq. 11 transform, its QKV
and gate+up fused. Then engine = solo on each mesh, int8 pools on 2 x 4,
speculative = plain greedy on 1 x 2, the packed bytes a rank holds on 1 x 8,
every write reaching the pool parts the data ranks share, a mesh of
distinct devices refused, the pinned ValueErrors, the layout search through `build_engine`, the refused
families and the CLI flags."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.kernels.ops import lut_serving
from repro.launch import engine as ref_engine
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.registry import get_model as ref_get_model
from repro_torch.convert import from_reference
from repro_torch.core.clustered_params import make_draft_params
from repro_torch.distributed import placement
from repro_torch.distributed.layout import SERVE_RULES, cache_shardings, serving_names
from repro_torch.distributed.sharding import Sharded, auto_shard, use_rules
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import cluster_params, np_of, port_model, reference_model, to_numpy_tree

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

CPU = torch.device("cpu")
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4), (2, 4)]
MESH_IDS = [f"{d}x{m}" for d, m in MESHES]
TINY = dict(arch_id="tiny-tp", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, head_dim=32, dtype="float32")


def _mesh(d, m):
    return make_mesh((d, m), ("data", "model"), [CPU] * (d * m))


def _ecfg(**kw):
    return dict(dict(num_slots=4, block_size=4, num_blocks=32, max_blocks_per_slot=8,
                     prefill_chunk=8), **kw)


def _prompts(n=3, vocab=256):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, int(rng.integers(5, 13))).astype(np.int32)
            for _ in range(n)]


class _Logits:
    """The engine's model with every serving step's and verify's logits kept."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def serving_step(self, *a):
        out = self.model.serving_step(*a)
        self.logits.append(out[0].clone())
        return out

    def serving_verify(self, *a):
        out = self.model.serving_verify(*a)
        self.logits.append(out[0].clone())
        return out


@pytest.fixture(scope="module")
def models():
    """name -> (port model, port params, reference model, reference params):
    tiny-tp dense, and reduced llama2-7b LCD (float / quantized transform),
    the same weights in both packages."""
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
    return out


def _serve(model, params, mesh=None, prompts=None, gen=8, **kw):
    """All prompts through one engine; (tokens per request, every step's
    logits, the engine)."""
    eng = port_engine.ServingEngine(model, params, port_engine.EngineConfig(**_ecfg(**kw)),
                                    mesh=mesh, device="cpu")
    eng.model = _Logits(model)
    reqs = [eng.submit(p, gen) for p in (prompts or _prompts(vocab=model.cfg.vocab))]
    eng.run()
    eng.assert_bounded_traces()
    return [list(r.out_tokens) for r in reqs], eng.model.logits, eng


_ONE_DEVICE = {}


def _one_device(models, name):
    """The 1 x 1 engine's run of `name`, made once."""
    if name not in _ONE_DEVICE:
        model, params, _, _ = models[name]
        _ONE_DEVICE[name] = _serve(model, params)[:2]
    return _ONE_DEVICE[name]


def _same_logits(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ["tiny", "llama_float", "llama_quant"])
def test_mesh_tokens_and_logits_equal_one_device_and_solo(models, name, shape):
    model, params, _, _ = models[name]
    ref_tokens, ref_logits = _one_device(models, name)
    tokens, logits, eng = _serve(model, params, _mesh(*shape))
    assert eng.mesh.shape == {"data": shape[0], "model": shape[1]}
    assert tokens == ref_tokens
    assert _same_logits(logits, ref_logits)
    assert set(eng.traces) <= {1, 8}
    for prompt, toks in zip(_prompts(vocab=model.cfg.vocab), tokens):
        solo, _, _ = _serve(model, params, _mesh(*shape), prompts=[prompt])
        assert solo[0] == toks


@pytest.mark.parametrize("name", ["tiny", "llama_float", "llama_quant"])
def test_one_device_tokens_equal_the_reference_engine(models, name):
    """The reference's quantized Eq. 11 transform runs through its kernels
    (`lut_serving("interpret")`); its default CPU route ignores act_scale."""
    model, params, rmodel, rparams = models[name]
    ref = ref_engine.ServingEngine(rmodel, rparams, ref_engine.EngineConfig(**_ecfg()))
    reqs = [ref.submit(p, 8) for p in _prompts(vocab=model.cfg.vocab)]
    with lut_serving("interpret" if name == "llama_quant" else None):
        ref.run()
    tokens, _ = _one_device(models, name)
    assert tokens == [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("name", ["tiny", "llama_quant"])
def test_int8_pools_on_2x4_equal_their_one_device_engine(models, name):
    model, params, _, _ = models[name]
    smooth = port_engine.calibrate_kv_smooth(model, params, n_tokens=16, batch=2)

    def run(mesh):
        eng = port_engine.ServingEngine(model, params, port_engine.EngineConfig(
            **_ecfg(kv_dtype="int8")), mesh=mesh, device="cpu", kv_smooth=smooth)
        eng.model = _Logits(model)
        reqs = [eng.submit(p, 8) for p in _prompts(vocab=model.cfg.vocab)]
        eng.run()
        return [list(r.out_tokens) for r in reqs], eng.model.logits

    want, want_logits = run(None)
    got, got_logits = run(_mesh(2, 4))
    assert got == want and _same_logits(got_logits, want_logits)


def test_speculative_on_1x2_equals_plain_greedy(models):
    model, params, _, _ = models["llama_float"]
    draft, _ = make_draft_params(params, draft_centroids=4)
    geometry = dict(max_blocks_per_slot=12, num_blocks=48)
    plain, _, _ = _serve(model, params, **geometry)
    eng = port_engine.ServingEngine(model, params, port_engine.EngineConfig(
        **_ecfg(speculative_k=3, **geometry)), mesh=_mesh(1, 2), device="cpu",
        draft_params=draft)
    reqs = [eng.submit(p, 8) for p in _prompts(vocab=model.cfg.vocab)]
    eng.run()
    eng.assert_bounded_traces()
    assert [list(r.out_tokens) for r in reqs] == plain
    assert eng.spec_rounds > 0
    assert isinstance(eng.draft_params, placement.MeshTree)


def test_weights_actually_sharded_on_1x8(models):
    """On a model = 8 mesh every cut ClusteredTensor is 8 parts, each with
    1/8 of its packed bytes (the reference's test_weights_actually_sharded:
    a spec names the model axis)."""
    model, params, _, _ = models["llama_float"]
    eng = port_engine.ServingEngine(model, params, mesh=_mesh(1, 8), device="cpu")
    tree = eng.params
    assert isinstance(tree, placement.MeshTree)
    n = 0
    for key in ("attn", "mlp"):
        for wname, leaf in tree.views[0]["blocks"][key].items():
            whole = params["blocks"][key][wname]
            assert isinstance(leaf, Sharded) and len(leaf.parts) == 8, wname
            for part in leaf.parts:
                pk = part.packed if part.packed is not None else part.codes
                wpk = whole.packed if whole.packed is not None else whole.codes
                assert pk.numel() * 8 == wpk.numel()
            n += 1
    assert n == 7
    assert any("model" in str(s) for s in jax.tree_util.tree_leaves(
        tree.specs, is_leaf=lambda x: isinstance(x, tuple)))


@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
def test_placed_pool_parts_get_every_write(models, kv_dtype):
    """The model step on placed trees of a 2 x 2 mesh, called directly:
    both data ranks write their slots' rows into the same parts, and the
    logits and every pool part equal the one-device step's."""
    model, params, _, _ = models["llama_quant"]
    cfg = model.cfg
    mesh = _mesh(2, 2)
    pool = model.init_seq_caches(num_blocks=16, block_size=4, num_slots=4, max_seq=32,
                                 kv_dtype=kv_dtype, device="cpu")["paged"]
    with use_rules(mesh, SERVE_RULES, fsdp=False):
        mp = placement.place(params, auto_shard(params, serving_names(model)), mesh)
        mc = placement.place(pool, cache_shardings(model, {"paged": pool})["paged"], mesh,
                             writable=True)
    whole_pool = {name: t.clone() for name, t in pool.items()}
    rng = np.random.default_rng(1)
    tables = torch.arange(16, dtype=torch.int32).view(4, 4)
    lengths = torch.zeros(4, dtype=torch.int32)
    for t, n_new in ((8, [8, 5, 0, 3]), (1, [1, 1, 0, 1]), (1, [1, 0, 1, 1])):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, t)).astype(np.int32))
        n_new = torch.tensor(n_new, dtype=torch.int32)
        want, _ = transformer.paged_decode_step(params, whole_pool, tokens, lengths, n_new,
                                                tables, cfg)
        got, _ = transformer.paged_decode_step(mp, mc, tokens, lengths, n_new, tables, cfg)
        assert torch.equal(got, want)
        for name, whole in whole_pool.items():
            leaf = mc.views[0][name]
            assert all(a is b for a, b in zip(leaf.parts, mc.views[1][name].parts)), name
            for m, part in enumerate(leaf.parts):
                cut = whole if leaf.dim is None else whole.chunk(2, dim=leaf.dim)[m]
                assert torch.equal(part, cut), name
        lengths = lengths + n_new


def test_a_mesh_of_distinct_devices_is_refused(models):
    """A mesh over distinct devices waits for a multi-process backend: the
    engine refuses it, naming it, before placing anything."""
    model, params, _, _ = models["tiny"]
    mesh = make_mesh((1, 2), ("data", "model"), [CPU, torch.device("cuda", 0)])
    with pytest.raises(NotImplementedError, match="distinct devices.*multi-process"):
        port_engine.ServingEngine(model, params, port_engine.EngineConfig(**_ecfg()),
                                  mesh=mesh, device="cpu")


def test_mesh_knob_surface_keeps_the_reference_wording(models):
    model, params, rmodel, rparams = models["tiny"]
    ecfg = dict(_ecfg(), model_parallel=4)
    with pytest.raises(ValueError) as want:
        ref_engine.ServingEngine(rmodel, rparams, ref_engine.EngineConfig(**ecfg),
                                 mesh=jax.make_mesh((1, 1), ("data", "model")))
    with pytest.raises(ValueError, match=r"model_parallel=4 does not match the engine "
                                         r"mesh's 'model' axis") as got:
        port_engine.ServingEngine(model, params, port_engine.EngineConfig(**ecfg),
                                  mesh=_mesh(1, 1))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"data_parallel x model_parallel must factor the 4 "
                                         r"visible device\(s\); got 3 x None"):
        port_engine.build_engine("llama2-7b", ecfg=port_engine.EngineConfig(
            **_ecfg(data_parallel=3)), device="cpu", devices=[CPU] * 4)


def test_build_engine_pins_or_searches_the_layout(models):
    """Knobs pin the mesh over the devices passed (the missing factor
    derived, no search); without knobs a device list the caller passes gets
    the roofline search and its report; no list, the one device."""
    _, params, _, _ = models["llama_float"]
    kw = dict(params=params, fused_projections=True, device="cpu", devices=[CPU] * 4)
    eng, _ = port_engine.build_engine("llama2-7b", ecfg=port_engine.EngineConfig(
        **_ecfg(model_parallel=2)), **kw)
    assert eng.mesh.shape == {"data": 2, "model": 2} and eng.layout_report is None
    eng, _ = port_engine.build_engine("llama2-7b", ecfg=port_engine.EngineConfig(**_ecfg()),
                                      **kw)
    report = eng.layout_report
    assert set(report["candidates"]) == {"4x1", "2x2", "1x4"}
    assert eng.mesh.shape == dict(zip(("data", "model"),
                                      (int(x) for x in report["chosen"].split("x"))))
    req = eng.submit(_prompts()[0], 4)
    eng.run()
    assert len(req.out_tokens) == 4
    eng, _ = port_engine.build_engine("llama2-7b", ecfg=port_engine.EngineConfig(**_ecfg()),
                                      params=params, device="cpu")
    assert eng.mesh.size == 1 and eng.layout_report is None


@pytest.mark.parametrize("arch,family", [("phi3.5-moe-42b-a6.6b", "moe"), ("rwkv6-1.6b", "rwkv"),
                                         ("zamba2-1.2b", "hybrid")])
def test_other_families_refuse_a_mesh_naming_the_family(arch, family):
    model = port_model(arch)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match=f"family '{family}'.*mesh"):
        port_engine.ServingEngine(model, params, mesh=_mesh(1, 2), device="cpu")
    one = port_engine.ServingEngine(model, params, mesh=_mesh(1, 1), device="cpu")
    assert one.mesh.size == 1


def test_cli_mesh_flags(capsys):
    """--data-parallel / --model-parallel: continuous mode only (the
    reference's ap.error), a non-factoring request raises, 1 x 1 serves."""
    argv = ["--arch", "llama2-7b", "--reduced", "--requests", "2", "--tokens", "3"]
    for flag in ("--model-parallel", "--data-parallel"):
        with pytest.raises(SystemExit):
            port_serve.main(argv + [flag, "2"], device="cpu")
        assert f"{flag} applies to the paged engine; add --continuous" in capsys.readouterr().err
    with pytest.raises(ValueError, match="must factor the 1 visible device"):
        port_serve.main(argv + ["--continuous", "--model-parallel", "2"], device="cpu")
    done = port_serve.main(argv + ["--lcd", "--continuous", "--data-parallel", "1",
                                   "--model-parallel", "1"], device="cpu")
    assert len(done) == 2 and all(len(r.out_tokens) == 3 for r in done)


def test_kv_smooth_reaches_every_rank(models):
    """Calibrated smoothing vectors installed before placement: each model
    rank's part holds its kv heads' rows."""
    model, params, _, _ = models["tiny"]
    smooth = port_engine.calibrate_kv_smooth(model, params, n_tokens=8, batch=2)
    eng = port_engine.ServingEngine(model, params, port_engine.EngineConfig(
        **_ecfg(kv_dtype="int8")), mesh=_mesh(1, 2), device="cpu", kv_smooth=smooth)
    parts = eng.caches["paged"].views[0]["k_smooth"].parts
    assert torch.equal(torch.cat(parts, dim=1), torch.from_numpy(np_of(smooth[0])))
    assert dataclasses.is_dataclass(eng.mesh)
