"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's `launch/dryrun.py`, on "meta" tensors and stand-in meshes.

The reference's dry run compiles every cell on 512 host devices; here its
pieces run on the one CPU device with nothing in `src/repro/` changed: its
`make_production_mesh` with `jax.make_mesh` recorded, its step bundles
built under its own rules on a stand-in mesh (`NamedSharding` replaced by
its spec, as in tests/test_torch_sharding.py), and its `bytes_per_dev`
formula (a closure of its `run_cell`, restated in `_ref_bytes`) over the
bundle's abstract inputs. For every cell of `--all` on (16, 16) and
(2, 16, 16), dense and `--lcd` decode: status and skip reason, the bundle's
specs and abstract shapes, `argument_size`, `param_bytes_per_dev`,
`cache_bytes_per_dev` and `model_flops` are the reference's, exactly. The
analytic cost model is held to the reference's own HLO walk
(`hlo_cost.analyze_text`) over reduced qwen2-1.5b's train and prefill
steps (4 x 64 tokens) at 1 x 1, each compiled once on the CPU device:
FLOPs within FLOPS_TOL = 5 % (stated before the first run; the count
came within 0.1 % for train and 1.4 % for prefill)."""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from repro.core import clustered_params as ref_cp
from repro.distributed import hlo_analysis as ref_H
from repro.distributed import sharding as ref_sharding
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro.models import config as ref_config
from repro.models.registry import get_model as ref_get_model
from repro_torch.launch import dryrun, mesh as port_mesh
from repro_torch.models import config as port_config
from repro_torch.models.registry import get_model
from repro_torch.tree import leaves

pytestmark = pytest.mark.tier1

FLOPS_TOL = 0.05
ARCHS = [a for a in port_config.list_archs() if a != "llama2-7b"]     # `--all`
MESHES = {"pod1": {"data": 16, "model": 16}, "pod2": {"pod": 2, "data": 16, "model": 16}}
META = torch.device("meta")


@pytest.fixture
def ref_specs_only(monkeypatch):
    """The reference's NamedSharding as its spec: a stand-in mesh has no
    devices to build one over."""
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: spec)


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1]


def _sig(tree):
    return [(tuple(x.shape), _dtype(x)) for x in leaves(tree)]


def _ref_sig(tree):
    import jax
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree_util.tree_leaves(tree)]


def test_make_production_mesh_equals_the_reference(monkeypatch):
    import jax
    seen = []
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: seen.append((shape, axes)))
    for multi_pod in (False, True):
        ref_mesh.make_production_mesh(multi_pod=multi_pod)
        n = 512 if multi_pod else 256
        m = port_mesh.make_production_mesh(multi_pod=multi_pod, devices=[META] * n)
        assert (tuple(m.devices.shape), m.axis_names) == tuple(map(tuple, seen[-1]))
    with pytest.raises(ValueError, match="needs 256 devices"):
        port_mesh.make_production_mesh(devices=[torch.device("cpu")] * 8)


@pytest.mark.parametrize("arch", port_config.list_archs())
def test_abstract_params_names_and_cache_equal_the_reference(arch):
    """Full size: every leaf's shape and dtype on "meta", the names, and the
    static cache (bf16 and int8) of the decode_32k shape."""
    for kv in ("bf16", "int8"):
        pc = dataclasses.replace(port_config.get_config(arch), kv_cache_dtype=kv)
        rc = dataclasses.replace(ref_config.get_config(arch), kv_cache_dtype=kv)
        port, ref = get_model(pc), ref_get_model(rc)
        if kv == "bf16":
            got = port.abstract()
            assert all(x.device == META for x in leaves(got))
            assert _sig(got) == _ref_sig(ref.abstract())
            assert port.names() == ref.names()
        cache = port.abstract_cache(128, 32768)
        assert all(x.device == META for x in leaves(cache))
        assert _sig(cache) == _ref_sig(ref.abstract_cache(128, 32768))


def _ref_bundle(arch, shape_name, mesh_shape, lcd):
    """The reference's bundle of a cell, built as its `run_cell` builds it
    (its rules, overrides and FSDP switch) on a stand-in mesh."""
    cfg = ref_config.get_config(arch)
    shape = ref_config.SHAPES[shape_name]
    model = ref_get_model(cfg)
    mesh = types.SimpleNamespace(shape=dict(mesh_shape))
    use_fsdp = shape.kind != "decode"
    overrides = {}
    if shape.kind == "decode" and cfg.family == "hybrid":
        overrides.setdefault("ssm_inner", None)
        overrides.setdefault("ssm_heads", None)
    if (shape.kind == "decode" and cfg.n_kv_heads % 16 == 0
            and shape.global_batch >= 32):
        overrides.setdefault("seq_kv", None)
    n = cfg.param_count(active_only=True)
    with ref_sharding.use_rules(mesh, overrides, fsdp=use_fsdp):
        if shape.kind == "train":
            return (ref_steps.build_train_step(model, shape),
                    ref_H.model_flops_train(n, shape.global_batch * shape.seq_len))
        if shape.kind == "prefill":
            return (ref_steps.build_prefill_step(model, shape),
                    ref_H.model_flops_decode(n, shape.global_batch * shape.seq_len))
        cl = ref_cp.clustered_abstract(model) if lcd else (None, None, None)
        return (ref_steps.build_serve_step(model, shape, clustered_params=cl[0],
                                           clustered_names=cl[1]),
                ref_H.model_flops_decode(n, shape.global_batch))


def _ref_specs(tree):
    import jax
    return [tuple(x) for x in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _ref_bytes(tree, specs, mesh_shape):
    """The reference's `bytes_per_dev` (src/repro/launch/dryrun.py), its
    shardings given as specs."""
    import jax
    import jax.numpy as jnp
    tot = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree), _ref_specs(specs)):
        n = int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize
        nshards = 1
        for ax in spec:
            if ax is None:
                continue
            for a in (ax,) if isinstance(ax, str) else ax:
                nshards *= mesh_shape.get(a, 1)
        tot += n // max(nshards, 1)
    return tot


def _check_invariants(r, one_by_one=False):
    terms = {"compute": r["t_compute"], "memory": r["t_memory"],
             "collective": r["t_collective"]}
    assert r["t_step"] == max(terms.values())
    assert terms[r["dominant"]] == r["t_step"]
    if one_by_one:
        assert r["coll_bytes_per_dev"] == 0 and not r["collectives"]
        assert r["t_collective"] == 0
    else:
        assert 0 < r["useful_flop_frac"] <= 1, r["useful_flop_frac"]


@pytest.mark.usefixtures("ref_specs_only")
@pytest.mark.parametrize("pod", list(MESHES))
@pytest.mark.parametrize("shape_name", list(port_config.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_the_reference(arch, shape_name, pod):
    """One cell of `--all` on the production mesh (and the `--lcd` cell of a
    decode shape): status and reason, specs, abstract inputs, per-rank
    bytes and model FLOPs equal the reference's; the roofline's
    invariants; the same cell at 1 x 1 has no collectives."""
    mesh_shape = MESHES[pod]
    ok, why = ref_config.shape_applicable(ref_config.get_config(arch),
                                          ref_config.SHAPES[shape_name])
    for lcd in (False, True) if port_config.SHAPES[shape_name].kind == "decode" else (False,):
        got = dryrun.run_cell(arch, shape_name, multi_pod=pod == "pod2", lcd=lcd, save=False)
        assert got["cell"] == dryrun.cell_name(arch, shape_name, multi_pod=pod == "pod2",
                                               lcd=lcd)
        if not ok:
            assert (got["status"], got["reason"]) == ("skipped", why)
            continue
        assert got["status"] == "ok" and got["mesh"] == mesh_shape
        want, want_flops = _ref_bundle(arch, shape_name, mesh_shape, lcd)
        model = get_model(port_config.get_config(arch))
        shape = port_config.SHAPES[shape_name]
        bundle, flops = dryrun.cell_bundle(model, shape, types.SimpleNamespace(
            shape=mesh_shape), lcd=lcd)
        assert [tuple(s.spec) for s in leaves(bundle.in_shardings)] == _ref_specs(
            want.in_shardings)
        assert [tuple(s.spec) for s in leaves(bundle.out_shardings)] == _ref_specs(
            want.out_shardings)
        assert _sig(bundle.abstract_inputs) == _ref_sig(want.abstract_inputs)
        assert flops == want_flops == got["model_flops"]
        assert got["memory"]["argument_size"] == _ref_bytes(
            want.abstract_inputs, want.in_shardings, mesh_shape)
        if shape.kind == "decode":
            assert got["param_bytes_per_dev"] == _ref_bytes(
                want.abstract_inputs[0], want.in_shardings[0], mesh_shape)
            assert got["cache_bytes_per_dev"] == _ref_bytes(
                want.abstract_inputs[1], want.in_shardings[1], mesh_shape)
        _check_invariants(got)
        one = dryrun.analyze_cell(model, shape, types.SimpleNamespace(
            shape={"data": 1, "model": 1}), lcd=lcd)
        _check_invariants(one, one_by_one=True)
        assert one["memory"]["argument_size"] == sum(
            math.prod(x.shape) * x.element_size() for x in leaves(bundle.abstract_inputs))


@pytest.fixture(scope="module")
def qwen2_hlo():
    """The reference's HLO count of reduced qwen2-1.5b's train and prefill
    steps at 4 x 64, each compiled once on the one CPU device."""
    import jax
    from repro.distributed.hlo_cost import analyze_text
    model = ref_get_model(ref_config.reduced(ref_config.get_config("qwen2-1.5b")))
    out = {}
    with ref_sharding.use_rules(jax.make_mesh((1, 1), ("data", "model"))):
        for kind in ("train", "prefill"):
            shape = ref_config.ShapeConfig(kind, 64, 4, kind)
            b = (ref_steps.build_train_step if kind == "train" else
                 ref_steps.build_prefill_step)(model, shape)
            compiled = jax.jit(b.fn, in_shardings=b.in_shardings,
                               out_shardings=b.out_shardings).lower(*b.abstract_inputs).compile()
            out[kind] = analyze_text(compiled.as_text()).flops
    return out


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flops_within_tolerance_of_the_reference_hlo(qwen2_hlo, kind):
    model = get_model(port_config.reduced(port_config.get_config("qwen2-1.5b")))
    got = dryrun.analyze_cell(model, port_config.ShapeConfig(kind, 64, 4, kind),
                              types.SimpleNamespace(shape={"data": 1, "model": 1}))
    assert abs(got["flops_per_dev"] / qwen2_hlo[kind] - 1) <= FLOPS_TOL, (
        got["flops_per_dev"], qwen2_hlo[kind])
    assert got["flops_by_dtype"] == {"f32": got["flops_per_dev"]}   # an f32 model
    _check_invariants(got, one_by_one=True)


def test_cli_writes_a_cell(tmp_path):
    import json
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--lcd",
                        "--out", str(tmp_path)]) == 0
    r = json.loads((tmp_path / "qwen2-1.5b__decode_32k__pod1__lcd.json").read_text())
    assert r["status"] == "ok" and r["chips"] == 256 and r["variant"] == "lcd"
    assert set(r["memory"]) == {"argument_size", "output_size", "temp_size", "total_per_chip"}
    assert r["engine"]["num_slots"] == 128 and r["engine"]["argument_size"] > 0


def test_a_cell_that_raises_is_an_error_cell(tmp_path, monkeypatch):
    """`run_all` reports a cell that raises as status "error" under its
    name and goes on; the CLI then exits 1."""
    real = dryrun.run_cell

    def run_cell(arch, shape_name, **kw):
        if shape_name == "prefill_32k":
            raise RuntimeError("boom")
        return real(arch, shape_name, **kw)
    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    cells = dryrun.run_all(True, True, str(tmp_path), archs=["qwen2-1.5b"],
                           shapes=["prefill_32k", "decode_32k"])
    assert [(c["cell"], c["status"]) for c in cells] == [
        ("qwen2-1.5b__prefill_32k__pod2__lcd", "error"),
        ("qwen2-1.5b__decode_32k__pod2__lcd", "ok")]
    assert cells[0]["reason"] == "RuntimeError: boom"
    assert dryrun.main(["--arch", "qwen2-1.5b", "--out", str(tmp_path)]) == 1


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b",
                                  "zamba2-1.2b"])
def test_a_pod_axis_scores_as_data_ranks(arch):
    """`score_layout` on (2, 16, 16) scores as on (32, 16): the pod axis
    composes with the data axis, so a rank's slots are 1/32 of them."""
    from repro_torch.distributed.cost import decode_ecfg
    from repro_torch.distributed.layout import score_layout
    model = get_model(port_config.get_config(arch))
    ecfg = decode_ecfg(model, port_config.SHAPES["decode_32k"])
    params = dryrun.lcd_abstract(model)
    pod = score_layout(model, params, ecfg, types.SimpleNamespace(shape=MESHES["pod2"]))
    flat = score_layout(model, params, ecfg, types.SimpleNamespace(
        shape={"data": 32, "model": 16}))
    assert pod == flat
