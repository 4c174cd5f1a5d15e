"""The port's sharding rules, placement and layout chooser against the JAX
package's own functions.

The reference's `logical_to_spec` / `auto_shard` read only `mesh.shape`, so
its `ShardingRules` take a stand-in object with a `.shape` dict: 1 x 1,
1 x 8, 2 x 4, 8 x 1 and a (2, 16, 16) pod shape on the one CPU device this
run has, with nothing in `src/repro/` changed (its `NamedSharding`, which
needs a real mesh, is replaced by the spec alone for the test). Specs must
be equal for every leaf of every arch's `reduced()` table, dense and LCD
(`materialize_clustered`); then the placement's shard shapes and packed
bytes, the pools' parts, the refusal of distinct devices, `candidate_layouts`, `choose_layout`'s report,
the step bundles' placements and the pinned `make_elastic_mesh` message."""
import types

import numpy as np
import pytest
import torch

from repro.core import clustered_params as ref_cp
from repro.distributed import layout as ref_layout
from repro.distributed import sharding as ref_sharding
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro.models import config as ref_config
from repro.models.registry import get_model as ref_get_model
from repro_torch.core.api import is_clustered
from repro_torch.core.clustered_params import materialize_clustered
from repro_torch.distributed import layout, placement, sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps as port_steps
from repro_torch.models import config as port_config
from repro_torch.models.registry import get_model

pytestmark = pytest.mark.tier1

ARCHS = port_config.list_archs()
MESHES = {"1x1": {"data": 1, "model": 1}, "1x8": {"data": 1, "model": 8},
          "2x4": {"data": 2, "model": 4}, "8x1": {"data": 8, "model": 1},
          "pod_2x16x16": {"pod": 2, "data": 16, "model": 16}}
CPU = torch.device("cpu")


@pytest.fixture
def ref_specs_only(monkeypatch):
    """The reference's NamedSharding as its spec: a stand-in mesh has no
    devices to build one over."""
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: spec)


def _rules(shape, fsdp):
    mesh = types.SimpleNamespace(shape=dict(shape))
    ref_rules = dict(ref_sharding.DEFAULT_RULES)
    port_rules = dict(sharding.DEFAULT_RULES)
    if not fsdp:
        ref_rules["embed"] = port_rules["embed"] = None
    return (ref_sharding.ShardingRules(mesh, ref_rules, fsdp),
            sharding.ShardingRules(mesh, port_rules, fsdp))


def _pairs(tree, names, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], names[k], prefix + (k,))
    else:
        yield prefix, tree, names


def _ref_model(arch):
    return ref_get_model(ref_config.reduced(ref_config.get_config(arch)))


def _port_model(arch):
    return get_model(port_config.reduced(port_config.get_config(arch)))


def test_rules_and_name_parsing_equal_the_reference():
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES
    for s in ("layers,embed,ff", "", ".", "vocab,.", "layers,.,kv,."):
        assert sharding.parse_names(s) == ref_sharding.parse_names(s)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_specs_equal_the_reference(arch):
    """Every leaf of the arch's reduced() table, on every mesh shape, with
    and without the FSDP rule."""
    port, ref = _port_model(arch), _ref_model(arch)
    assert port.names() == ref.names()
    leaves = list(_pairs(port.abstract(), port.names()))
    assert leaves
    for shape in MESHES.values():
        for fsdp in (True, False):
            ref_sr, port_sr = _rules(shape, fsdp)
            for path, x, names in leaves:
                nm = sharding.parse_names(names)
                got = sharding.logical_to_spec(tuple(x.shape), nm, port_sr)
                want = ref_sharding.logical_to_spec(tuple(x.shape), nm, ref_sr)
                assert tuple(got) == tuple(want), (arch, shape, fsdp, path)


@pytest.mark.usefixtures("ref_specs_only")
@pytest.mark.parametrize("arch", ARCHS)
def test_lcd_auto_shard_equals_the_reference(arch):
    """`auto_shard` over the arch's LCD tree (the port's
    `materialize_clustered`, the reference's `clustered_abstract` of the
    same model): every ClusteredTensor field's spec and every dense leaf's."""
    port, ref = _port_model(arch), _ref_model(arch)
    pparams = materialize_clustered(port, torch.Generator().manual_seed(0), device="cpu")
    rparams = ref_cp.clustered_abstract(ref, nbits=4)[0]
    n_clustered = 0
    for shape in MESHES.values():
        for fsdp in (True, False):
            ref_sr, port_sr = _rules(shape, fsdp)
            got = sharding.auto_shard(pparams, port.names(), port_sr)
            want = ref_sharding.auto_shard(rparams, ref.names(), ref_sr)
            for path, g, _ in _pairs(got, port.names()):
                w = want
                for k in path:
                    w = w[k]
                if is_clustered(g):
                    n_clustered += 1
                    for f in ("codes", "codebook", "smooth", "packed", "inv_scale",
                              "act_scale"):
                        gf, wf = getattr(g, f), getattr(w, f)
                        assert (gf is None) == (wf is None), (arch, path, f)
                        if gf is not None:
                            assert tuple(gf.spec) == tuple(wf), (arch, shape, path, f)
                else:
                    assert tuple(g.spec) == tuple(w), (arch, shape, fsdp, path)
    assert n_clustered > 0


LOGICAL_CASES = [((12, 64), ("heads", "embed")), ((16, 64), ("heads", "ff")),
                 ((6, 32), ("batch", "seq_kv")), ((1, 32), ("batch", "seq_kv")),
                 ((64, 64), ("ff", "q_dim")), ((2, 8, 4, 2, 32), ("layers", "blocks", None,
                                                                  "kv", None)),
                 ((32,), ("slots",)), ((4, 7), ("experts", "vocab"))]


@pytest.mark.parametrize("shape_names", LOGICAL_CASES, ids=str)
def test_divisibility_fallback_suffix_and_axis_once_equal_the_reference(shape_names):
    shape, names = shape_names
    for mshape in MESHES.values():
        ref_sr, port_sr = _rules(mshape, True)
        assert tuple(sharding.logical_to_spec(shape, names, port_sr)) == tuple(
            ref_sharding.logical_to_spec(shape, names, ref_sr)), mshape


def _llama_lcd():
    model = _port_model("llama2-7b")
    return model, materialize_clustered(model, torch.Generator().manual_seed(0), device="cpu")


def test_placement_cuts_codes_by_columns_and_holds_one_part_a_rank():
    """The serving placement on a 2 x 4 mesh of CPUs: every cut
    ClusteredTensor's parts hold 1/4 of its packed bytes, cut by the output
    columns (wo and w_down too: ROADMAP C), smoothing vectors whole; the
    vocab tables whole; data rank 1's parts ARE data rank 0's (the devices
    repeat, `.to` aliases)."""
    model, params = _llama_lcd()
    mesh = port_mesh.make_mesh((2, 4), ("data", "model"), [CPU] * 8)
    with sharding.use_rules(mesh, layout.SERVE_RULES, fsdp=False):
        tree = placement.place(params, sharding.auto_shard(
            params, layout.serving_names(model)), mesh)
    cut = 0
    for path, leaf, _ in _pairs(params, model.names()):
        got = tree.views[0]
        again = tree.views[1]
        for k in path:
            got, again = got[k], again[k]
        if path in (("embed",), ("lm_head",)) or not is_clustered(leaf):
            assert not isinstance(got, sharding.Sharded) and got is leaf, path
            continue
        assert isinstance(got, sharding.Sharded) and got.dim == leaf.codes.ndim - 1, path
        cut += 1
        for m, part in enumerate(got.parts):
            n = leaf.codes.shape[-1] // 4
            # materialize_clustered keeps the packed bytes in `codes`
            for f in ("codes", "packed"):
                whole, mine = getattr(leaf, f), getattr(part, f)
                if whole is None:
                    assert mine is None
                    continue
                assert torch.equal(mine, whole[..., m * n:(m + 1) * n])
                assert mine.numel() * 4 == whole.numel()
                assert mine is getattr(again.parts[m], f)
            assert part.smooth is leaf.smooth and part.codebook is leaf.codebook
    assert cut == 7


def test_a_cut_along_k_falls_on_whole_k_blocks():
    """The reference's names cut wo by its input dim (q_dim): placed as
    such, each part holds whole 8-channel k-blocks (packed rows 4 a block at
    4 bits); a cut inside a k-block is refused."""
    model, params = _llama_lcd()
    mesh = port_mesh.make_mesh((1, 4), ("data", "model"), [CPU] * 4)
    wo = params["blocks"]["attn"]["wo"]
    with sharding.use_rules(mesh, fsdp=False):
        sh = sharding.auto_shard({"wo": wo}, {"wo": "layers,q_dim,embed"})
        tree = placement.place({"wo": wo}, sh, mesh)
    part = tree.views[0]["wo"]
    assert part.dim == 1 and part.parts[1].smooth.shape[-1] == wo.smooth.shape[-1] // 4
    # 128 input channels in 4 parts: 32 channels, 16 packed rows at 4 bits
    assert torch.equal(part.parts[1].codes, wo.codes[:, 16:32])
    odd = wo._replace(codes=wo.codes[:, :12], smooth=wo.smooth[:, :24],
                      inv_scale=None if wo.inv_scale is None else wo.inv_scale[:, :24])
    mesh2 = port_mesh.make_mesh((1, 2), ("data", "model"), [CPU] * 2)
    with sharding.use_rules(mesh2, fsdp=False):
        sh = sharding.auto_shard({"wo": odd}, {"wo": "layers,q_dim,embed"})
        with pytest.raises(ValueError, match="whole 8-channel k-blocks"):
            placement.place({"wo": odd}, sh, mesh2)


@pytest.mark.parametrize("n_model", [2, 8], ids=["cut", "whole"])
def test_pools_cut_on_kv_heads_one_tensor_a_part(n_model):
    """The paged pool on 2 x n_model: at model 2 each model rank holds its
    kv heads of every block; at model 8 (4 kv heads) it stays whole, the
    divisibility fallback, one tensor on every rank. Either way both data
    ranks hold the same tensors, so what one writes the other reads."""
    model = _port_model("llama2-7b")
    pool = model.init_seq_caches(num_blocks=8, block_size=4, num_slots=4, max_seq=16,
                                 kv_dtype="int8", device="cpu")
    pool["paged"]["k"].copy_(torch.randint(-5, 5, pool["paged"]["k"].shape))
    mesh = port_mesh.make_mesh((2, n_model), ("data", "model"), [CPU] * (2 * n_model))
    with sharding.use_rules(mesh, fsdp=False):
        sh = layout.cache_shardings(model, pool)
        tree = placement.place(pool["paged"], sh["paged"], mesh, writable=True)
    k0, k1 = tree.views[0]["k"], tree.views[1]["k"]
    assert len(k0.parts) == n_model and all(a is b for a, b in zip(k0.parts, k1.parts))
    if n_model == 2:
        assert tuple(sh["paged"]["k"].spec) == (None, None, None, "model", None)
        assert k0.dim == 3 and torch.equal(k0.parts[1], pool["paged"]["k"][:, :, :, 2:4])
        assert len(tree.named_tensors("k")) == 2
        assert tuple(tree.views[0]["k_smooth"].parts[0].shape) == (4, 2, 32)
    else:
        assert k0.dim is None and all(p is pool["paged"]["k"] for p in k0.parts)
        assert tree.named_tensors("k") == [pool["paged"]["k"]]


def test_a_mesh_of_distinct_devices_is_not_placed():
    """One process serves a mesh whose devices repeat; a mesh over distinct
    devices waits for a multi-process backend and is refused, naming it."""
    model = _port_model("llama2-7b")
    pool = model.init_seq_caches(num_blocks=8, block_size=4, num_slots=4, max_seq=16,
                                 device="cpu")
    mesh = port_mesh.make_mesh((1, 2), ("data", "model"), [CPU, torch.device("cuda", 0)])
    assert not mesh.one_device
    with sharding.use_rules(mesh, fsdp=False):
        sh = layout.cache_shardings(model, pool)
        with pytest.raises(NotImplementedError, match="distinct devices.*multi-process"):
            placement.place(pool["paged"], sh["paged"], mesh, writable=True)


@pytest.mark.parametrize("n", range(1, 17))
def test_candidate_layouts_equal_the_reference(n):
    assert layout.candidate_layouts(n) == ref_layout.candidate_layouts(n)


def test_choose_layout_scores_every_factorization():
    """The report's keys and candidate set are the reference's (its own
    test over 8 devices); every row is a positive roofline time; the mesh
    is the chosen one."""
    from repro_torch.launch.engine import EngineConfig
    model, params = _llama_lcd()
    ecfg = EngineConfig(num_slots=8, block_size=4, num_blocks=32, max_blocks_per_slot=8)
    mesh, report = layout.choose_layout(model, params, ecfg, devices=[CPU] * 8)
    assert set(report) == {"devices", "candidates", "chosen"} and report["devices"] == 8
    assert set(report["candidates"]) == {"1x8", "2x4", "4x2", "8x1"}
    assert report["chosen"] in report["candidates"]
    for key, row in report["candidates"].items():
        assert set(row) == {"flops", "bytes", "coll_bytes", "coll_counts", "t_model_s"}
        assert row["t_model_s"] > 0 and row["flops"] > 0 and row["coll_bytes"] > 0
    assert mesh.shape == dict(zip(("data", "model"),
                                  (int(x) for x in report["chosen"].split("x"))))
    rows = report["candidates"]
    # the model axis gathers every layer, the data axis once a step
    assert rows["1x8"]["coll_counts"]["all-gather"] > rows["8x1"]["coll_counts"]["all-gather"]
    assert rows["1x8"]["coll_bytes"] > rows["8x1"]["coll_bytes"]


def test_make_elastic_mesh_message_equals_the_reference():
    with pytest.raises(ValueError) as want:
        ref_mesh.make_elastic_mesh(5, model_parallel=2)
    with pytest.raises(ValueError, match=r"n_chips \(5\) must be a positive multiple of "
                                         r"model_parallel \(2\)") as got:
        port_mesh.make_elastic_mesh(5, model_parallel=2)
    assert str(got.value) == str(want.value)
    m = port_mesh.make_elastic_mesh(8, model_parallel=2, chips_per_pod=4, devices=[CPU] * 8)
    assert m.shape == {"pod": 2, "data": 2, "model": 2}
    assert port_mesh.make_host_mesh([CPU] * 3).shape == {"data": 3, "model": 1}


@pytest.mark.usefixtures("ref_specs_only")
@pytest.mark.parametrize("kind", ["serve", "prefill"])
def test_step_bundles_place_like_the_reference(kind):
    """build_serve_step / build_prefill_step: the params', cache's, batch's
    and outputs' specs equal the reference's on a 2 x 4 mesh, and the
    abstract inputs have its shapes (tensors on "meta")."""
    arch = "llama2-7b"
    port, ref = _port_model(arch), _ref_model(arch)
    shape = {"serve": ("d", 64, 8, "decode"), "prefill": ("p", 64, 8, "prefill")}[kind]
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    with ref_sharding.use_rules(mesh):
        want = (ref_steps.build_serve_step if kind == "serve" else ref_steps.build_prefill_step)(
            ref, ref_config.ShapeConfig(*shape))
    with sharding.use_rules(mesh):
        got = (port_steps.build_serve_step if kind == "serve" else port_steps.build_prefill_step)(
            port, port_config.ShapeConfig(*shape))
    import jax

    def flat(tree):
        return [tuple(x) for x in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]

    def flat_port(tree):
        if isinstance(tree, dict):
            return [s for k in sorted(tree) for s in flat_port(tree[k])]
        if isinstance(tree, (tuple, list)) and not isinstance(tree, sharding.NamedSharding):
            return [s for t in tree for s in flat_port(t)]
        return [tuple(tree.spec)]

    assert flat_port(got.in_shardings) == flat(want.in_shardings)
    assert flat_port(got.out_shardings) == flat(want.out_shardings)
    got_shapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(
        got.abstract_inputs)]
    want_shapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(want.abstract_inputs)]
    assert got_shapes == want_shapes
    assert all(x.device.type == "meta" for x in jax.tree_util.tree_leaves(got.abstract_inputs))


@pytest.mark.parametrize("name", list(port_config.SHAPES))
def test_shapes_and_input_specs_equal_the_reference(name):
    for arch in ("llama2-7b", "paligemma-3b", "whisper-large-v3", "rwkv6-1.6b"):
        pc, rc = port_config.get_config(arch), ref_config.get_config(arch)
        ps, rs = port_config.SHAPES[name], ref_config.SHAPES[name]
        assert (ps.name, ps.seq_len, ps.global_batch, ps.kind) == (
            rs.name, rs.seq_len, rs.global_batch, rs.kind)
        assert port_config.shape_applicable(pc, ps) == ref_config.shape_applicable(rc, rs)
        got = port_config.input_specs(pc, ps, per_host_batch=2)
        want = ref_config.input_specs(rc, rs, per_host_batch=2)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_maybe_shard_gathers_in_rank_order_where_the_names_leave_a_dim_whole():
    mesh = port_mesh.make_mesh((1, 4), ("data", "model"), [CPU] * 4)
    x = torch.arange(2 * 3 * 16, dtype=torch.float32).view(2, 3, 16)
    cut = sharding.Sharded(tuple(x.split(4, dim=2)), 2)
    assert sharding.maybe_shard(x, "batch", None, None) is x          # a tensor: as it is
    with sharding.use_rules(mesh, fsdp=False):
        assert sharding.maybe_shard(cut, "batch", None, "ff") is cut   # cut as the names say
        assert torch.equal(sharding.maybe_shard(cut, "batch", None, None), x)
        assert torch.equal(sharding.maybe_shard(cut, "batch", None, "embed"), x)
    rows = sharding.Sharded(tuple(x.split(1, dim=0)), 0, axis="data")
    assert torch.equal(sharding.maybe_shard(rows, None, None, None), x)
    assert placement.data_rows(port_mesh.make_mesh((2, 1), ("data", "model"), [CPU] * 2),
                               4) == [slice(0, 2), slice(2, 4)]
    assert placement.data_rows(port_mesh.make_mesh((4, 1), ("data", "model"), [CPU] * 4),
                               6) == [slice(None)] * 4
    assert np.prod(list(mesh.shape.values())) == mesh.size == 4
