"""Placement: a parameter tree, a ClusteredTensor, a KV pool or a training
state cut into one shard per (data, model) mesh coordinate, from the specs
of `distributed/sharding.py`.

The JAX package commits its trees to a mesh with `jax.device_put(tree,
shardings)` and lets GSPMD partition every step. The port runs a mesh from
one process over one repeated device: `place` cuts each leaf on the dims its
spec gives the mesh axes (a contiguous tensor per part), and a leaf left
whole (and a model axis of 1) is the caller's tensor where it already lies
on the mesh's device. A one-process mesh of distinct cards is refused; such
a mesh is a process mesh (`launch/mesh.py ProcessMesh`: one process per
coordinate), on which `place` keeps only this process's coordinate, for
serving: one data rank's view, one model rank's parts (each `Sharded` over
the model group), on this process's device.

Serving (`fsdp=False`, the default, and `writable=`):

  * only the model axis cuts: every data rank holds the same tensors, so
    its replicas cost no memory, and a data or pod cut is refused;
  * a ClusteredTensor's `codes` and `packed` are cut on the dense weight's
    cut dim; a cut along K must fall on whole 8-channel k-blocks (the
    packing group of the LUT kernels, kernels/csrc/lut_common.cuh);
    `smooth` and `inv_scale` are cut like the input dims; `codebook` and
    `act_scale` stay whole, except where the cut is a stack dim (an MoE
    layer's experts): every field that carries it is cut there too, so a
    rank resolves its own experts with their own codebooks;
  * a pool is cut on `kv`: each model rank holds its kv-head shard of every
    block, so block tables stay valid everywhere; the data ranks write their
    slots' rows into the same parts. Slot state likewise: cut on its head
    dim (or its inner dim), never on the data axis: the data ranks share
    its tensors and each writes its own slots' rows (`data_rows`).

Training (`fsdp=True`: a tree cut by the reference's own training specs,
`tree_shardings` under `use_rules(mesh)`; params, Adam moments, EF state):
the `embed` rule cuts a weight's d_model dim over the compound data axis
(("pod", "data"), as the reference writes it: ZeRO-3-style FSDP), so each
data rank holds its own part, a tensor of its own, and the model axis cuts
as it does when serving. A leaf no rule cuts stays one shared tensor, so
the distinct tensors of a placed state hold exactly the whole state's
bytes. `MeshTree.whole` gathers every leaf whole in data-rank order (the
FSDP all-gather a rank makes before its forward); `cut_like` cuts a whole
tree (a summed gradient) back to each rank's part (the reduce-scatter's
cut).

The result is a `MeshTree`: one tree per data rank (per (pod, data)
coordinate, row-major, on a mesh with a pod axis) whose model-cut leaves
are `Sharded` (parts per model rank) and whose other leaves are plain
tensors on the mesh's device (pool leaves are always `Sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import CT_ARRAY_FIELDS, is_clustered, map_arrays
from repro_torch.distributed.sharding import (PartitionSpec, Sharded, gather,
                                              logical_to_spec, use_rules)
from repro_torch.launch.mesh import is_process_mesh, refuse_process_mesh, require_one_device
from repro_torch.tree import flatten_with_paths, unflatten

# input channels of one k-block: the packing group of every width
K_BLOCK = 8

# the axes of the compound data axis, in the order the reference's rules
# write them
DATA_AXES = ("pod", "data")


def _is_namedtuple(x) -> bool:
    """A NamedTuple node of a tree (AdamState, EFState); a ClusteredTensor
    is a leaf here."""
    return isinstance(x, tuple) and hasattr(x, "_fields") and not is_clustered(x)


def data_ranks(mesh) -> List[Dict[str, int]]:
    """The coordinates of every data rank on the mesh's data axes (pod and
    data), row-major: the order of a `MeshTree`'s views."""
    axes = [a for a in mesh.axis_names if a in DATA_AXES]
    sizes = [mesh.shape[a] for a in axes]
    return [dict(zip(axes, c)) for c in np.ndindex(*sizes)] if axes else [{}]


def _part_index(mesh, coords: Dict[str, int], axes: Tuple[str, ...]) -> int:
    """The part a data rank at `coords` holds of a dim cut on `axes`
    (row-major over them, as a compound axis)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


@dataclasses.dataclass(frozen=True, eq=False)
class MeshTree:
    """A tree placed on a (data, model) mesh: `views[d]` is data rank d's
    tree; `specs` the PartitionSpecs it was cut by (a ClusteredTensor of
    specs for a clustered leaf)."""
    mesh: Any
    views: Tuple[Any, ...]
    specs: Any

    def tensors(self) -> List[torch.Tensor]:
        """Every distinct tensor of the tree on the mesh, in a fixed order."""
        seen, out = set(), []
        for view in self.views:
            for t in _leaf_tensors(view):
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def named_tensors(self, name: str) -> List[torch.Tensor]:
        """Every distinct tensor holding a part of top-level leaf `name`."""
        seen, out = set(), []
        for view in self.views:
            for t in _leaf_tensors(view[name]):
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def rank_tree(self, model_rank: int = 0, data_rank: int = 0):
        """The tree as one rank holds it: each cut leaf's part of
        `model_rank`, in data rank `data_rank`'s view."""
        def part(x):
            if isinstance(x, Sharded):
                return x.parts[model_rank]
            if isinstance(x, dict):
                return {k: part(v) for k, v in x.items()}
            return x
        return part(self.views[data_rank])

    def __contains__(self, name: str) -> bool:
        return name in self.views[0]

    def __getitem__(self, key) -> "MeshTree":
        """The subtree at a dict key or a NamedTuple field (`state["params"]`,
        `opt["m"]`), placed as it is."""
        def sub(t):
            return t[key] if isinstance(t, dict) else getattr(t, key)
        return MeshTree(self.mesh, tuple(sub(v) for v in self.views), sub(self.specs))

    def leaf_groups(self) -> List[Tuple[str, Any, List[List[torch.Tensor]]]]:
        """Per tensor leaf, in the flattening order of `repro_torch.tree`:
        (path, spec, groups), `groups` the leaf's distinct data parts in
        data-rank order, each the list of its model parts in model-rank
        order (one where the model axis leaves the leaf whole)."""
        flat = [flatten_with_paths(v) for v in self.views]
        specs = flatten_with_paths(self.specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
        out = []
        for i, (path, spec) in enumerate(specs):
            seen, groups = set(), []
            for f in flat:
                x = f[i][1]
                if isinstance(x, Sharded):
                    parts = list(x.parts) if x.dim is not None else [x.parts[0]]
                else:
                    parts = [x]
                if not all(isinstance(p, torch.Tensor) for p in parts):
                    raise TypeError(f"MeshTree: {path} holds {type(parts[0]).__name__}; "
                                    f"only a tree of tensors gathers or updates by parts")
                key = tuple(id(p) for p in parts)
                if key not in seen:
                    seen.add(key)
                    groups.append(parts)
            out.append((path, spec, groups))
        return out

    def parts(self) -> List[torch.Tensor]:
        """Every distinct tensor of a tree of tensors, leaf by leaf
        (`leaf_groups` order: data parts in rank order, each's model parts
        in rank order): the order a placed step sums and updates in."""
        return [t for _, _, groups in self.leaf_groups() for ps in groups for t in ps]

    def with_parts(self, new: List[torch.Tensor]) -> "MeshTree":
        """The tree with its distinct tensors replaced, in `parts()` order, by
        `new`, every view and the aliasing between them kept."""
        old = self.parts()
        if len(old) != len(new):
            raise ValueError(f"MeshTree.with_parts: {len(new)} tensors for {len(old)} parts")
        made = {id(o): n for o, n in zip(old, new)}
        return MeshTree(self.mesh, tuple(_map_leaves(v, lambda t: made[id(t)])
                                         for v in self.views), self.specs)

    def whole(self) -> Any:
        """The tree with every leaf whole: its model parts concatenated in
        rank order, then its data parts in data-rank order (the FSDP
        all-gather), on the mesh's device. A leaf no axis cuts is its one
        tensor, not a copy."""
        wholes = []
        for _, spec, groups in self.leaf_groups():
            data_dim, _, model_dim = _cut_dims(spec, "MeshTree.whole")
            blocks = [ps[0] if model_dim is None else gather(ps, model_dim) for ps in groups]
            wholes.append(blocks[0] if data_dim is None else gather(blocks, data_dim))
        return unflatten(self.views[0], wholes)

    def clone(self) -> "MeshTree":
        """A copy of every distinct tensor, the aliasing kept."""
        made: Dict[int, torch.Tensor] = {}

        def cl(t):
            if id(t) not in made:
                made[id(t)] = t.clone()
            return made[id(t)]
        return MeshTree(self.mesh, tuple(_map_leaves(v, cl) for v in self.views), self.specs)


def _leaf_tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, Sharded):
        return [t for p in tree.parts for t in _leaf_tensors(p)]
    if is_clustered(tree):
        return [getattr(tree, f) for f in CT_ARRAY_FIELDS if getattr(tree, f) is not None]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaf_tensors(tree[k])]
    if _is_namedtuple(tree):
        return [t for f in tree._fields for t in _leaf_tensors(getattr(tree, f))]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _map_leaves(tree, fn):
    if isinstance(tree, Sharded):
        return tree.map(lambda p: _map_leaves(p, fn))
    if is_clustered(tree):
        return map_arrays(tree, fn)
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_leaves(getattr(tree, f), fn) for f in tree._fields))
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _model_dim(spec, what: str, shared: Tuple[str, ...] = ()) -> Optional[int]:
    """The dim `spec` cuts on the model axis (None: whole). A cut on the
    `shared` axes is dropped (a writable tree's slots: every data rank
    holds the same tensors); any other cut on the data or pod axis (FSDP)
    is refused: a serving placement cuts on the model axis only (a
    training one, `place(fsdp=True)`, reads `_cut_dims`)."""
    dim = None
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        axes = tuple(a for a in axes if a not in shared)
        if any(a != "model" for a in axes):
            raise NotImplementedError(
                f"place: {what} is cut on {axes}; only the model axis cuts a "
                f"parameter or a pool when serving (a training state's FSDP cut is "
                f"placed with fsdp=True)")
        if axes:
            dim = i
    return dim


def _cut_dims(spec, what: str) -> Tuple[Optional[int], Tuple[str, ...], Optional[int]]:
    """(data dim, its axes, model dim) of a training spec: the dim cut on
    the data axes (pod and / or data, one compound axis) and the dim cut on
    the model axis, None where no axis cuts. A spec that mixes the model
    axis with a data axis on one dim, or cuts two dims on data axes, is
    refused."""
    data_dim, data_axes, model_dim = None, (), None
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if not axes:
            continue
        if axes == ("model",):
            model_dim = i
        elif "model" in axes or data_dim is not None or not set(axes) <= set(DATA_AXES):
            raise NotImplementedError(
                f"{what}: a spec {tuple(spec)} cuts more than one dim on the data axes "
                f"or a dim on both the data and the model axes")
        else:
            data_dim, data_axes = i, axes
    return data_dim, data_axes, model_dim


def _cut(x: torch.Tensor, dim: Optional[int], m: int,
         which: Optional[List[int]] = None) -> List[torch.Tensor]:
    """The parts `which` (default: all m) of `x` cut on `dim` into m."""
    which = range(m) if which is None else which
    if dim is None:
        return [x] * len(which)
    size = x.shape[dim] // m
    return [x.narrow(dim, i * size, size).contiguous() for i in which]


def _cut_clustered(ct, shardings, m: int, what: str, which: Optional[List[int]] = None):
    """(parts `which` (default: all m), cut dim of the dense weight) of a
    ClusteredTensor."""
    fields: Dict[str, List] = {}
    dims: Dict[str, Optional[int]] = {}
    for f in CT_ARRAY_FIELDS:
        arr, ns = getattr(ct, f), getattr(shardings, f)
        if arr is None:
            continue
        dims[f] = _model_dim(ns.spec, f"{what}.{f}")
        fields[f] = _cut(arr, dims[f], m, which)
    dim = dims["codes"]
    if dim is not None and dim < ct.codes.ndim - 2:
        # a stack dim (experts): every field carrying it follows the cut
        lead = tuple(ct.codes.shape[:dim + 1])
        for f in fields:
            arr = getattr(ct, f)
            if dims[f] is None and tuple(arr.shape[:dim + 1]) == lead:
                dims[f], fields[f] = dim, _cut(arr, dim, m, which)
    d_in = ct.smooth.shape[-1]
    if dim is not None and dim == ct.codes.ndim - 2 and (d_in // m) % K_BLOCK:
        raise ValueError(
            f"place: {what} is cut along K (d_in {d_in}) into {m} parts of "
            f"{d_in // m} channels; a cut must fall on whole {K_BLOCK}-channel k-blocks")
    parts = [ct._replace(**{f: v[i] for f, v in fields.items()})
             for i in range(len(fields["codes"]))]
    return parts, dim


def place(tree, shardings, mesh, *, writable: bool = False, fsdp: bool = False) -> MeshTree:
    """Cut `tree` (nested dicts and NamedTuples of tensors and
    ClusteredTensors) by `shardings` (the matching tree of NamedShardings,
    `auto_shard` / `cache_shardings` / `tree_shardings`, or of their specs)
    onto `mesh` (axes "data" and "model", and "pod" for a training state),
    whose devices must repeat (`launch/mesh.py require_one_device`). Each
    part is moved to the mesh's device once and every data rank's view
    holding it holds that same tensor. `writable` marks a tree the step
    writes (a pool, slot state): its leaves are always `Sharded` and never
    cut on the data axis, so a write by one data rank is what every other
    reads. `fsdp` marks a training state (params, Adam moments, EF state):
    a tensor leaf's cut on the data axes (the reference's FSDP `embed`
    rule) gives each data rank its own part (`_cut_dims`); without it such
    a cut is refused.

    On a process mesh only this process's coordinate is placed, for
    serving: one view (its data rank's) whose cut leaves are `Sharded`
    over its model group, holding its model rank's part alone, on its
    device."""
    require_one_device(mesh, "place")
    if fsdp:
        refuse_process_mesh(mesh, "training (a placed training state)", "A7.5")
    process = is_process_mesh(mesh)
    ranks = [mesh.coord] if process else data_ranks(mesh)
    n_model = mesh.shape.get("model", 1)
    # the model ranks whose parts this process holds, and the group they form
    mine = [mesh.coord.get("model", 0)] if process else list(range(n_model))
    group = mesh.groups.get("model") if process else None
    dev = mesh.lead_device

    def to(x):
        if is_clustered(x):
            return map_arrays(x, to)
        return x.to(dev)

    shared = DATA_AXES if writable else ()

    def fsdp_leaf(x, spec, what):
        data_dim, data_axes, model_dim = _cut_dims(spec, f"place: {what}")
        n_groups = int(np.prod([mesh.shape[a] for a in data_axes]))
        groups = _cut(x, data_dim, n_groups) if data_dim is not None else [x]
        leaves = []
        for g in groups:
            if model_dim is None:
                leaves.append(to(g))
            else:
                leaves.append(Sharded(tuple(to(p) for p in _cut(g, model_dim, n_model)),
                                      model_dim))
        return [leaves[_part_index(mesh, c, data_axes)] for c in ranks]

    def one(x, ns, what):
        if x is None:
            return [None] * len(ranks)
        spec = getattr(ns, "spec", ns)
        if fsdp and not is_clustered(x):
            return fsdp_leaf(x, spec, what)
        if is_clustered(x):
            parts, dim = _cut_clustered(x, ns, n_model, what, mine)
        else:
            dim = _model_dim(spec, what, shared)
            parts = _cut(x, dim, n_model, mine)
        parts = [to(p) for p in parts] if dim is not None else [to(x)] * len(mine)
        leaf = (Sharded(tuple(parts), dim, group=group) if dim is not None or writable
                else parts[0])
        return [leaf] * len(ranks)

    def walk(x, ns, what):
        if isinstance(x, dict):
            got = {k: walk(x[k], ns[k], f"{what}/{k}" if what else k) for k in x}
            return [{k: v[d] for k, v in got.items()} for d in range(len(ranks))]
        if _is_namedtuple(x):
            got = [walk(getattr(x, f), getattr(ns, f), f"{what}.{f}") for f in x._fields]
            return [type(x)(*(v[d] for v in got)) for d in range(len(ranks))]
        return one(x, ns, what)

    views = walk(tree, shardings, "")
    specs = _specs(shardings)
    return MeshTree(mesh, tuple(views), specs)


def cut_model(tree, shardings, n_model: int):
    """`tree` (nested dicts of tensors) cut over a model axis of `n_model`
    by `shardings` (NamedShardings or specs without a data cut): each leaf
    its spec cuts on the model axis a `Sharded` of contiguous parts, every
    other leaf as it is. Nothing moves device, and the parts are
    differentiable slices of the leaf: the compute layout a training step's
    ranks run on, made from the leaves gathered whole."""
    if isinstance(tree, dict):
        return {k: cut_model(tree[k], shardings[k], n_model) for k in tree}
    dim = _cut_dims(getattr(shardings, "spec", shardings), "cut_model")[2]
    if dim is None or n_model == 1:
        return tree
    return Sharded(tuple(_cut(tree, dim, n_model)), dim)


def cut_like(tree, like: MeshTree) -> MeshTree:
    """A whole tree of `like`'s structure (a gradient summed over the data
    ranks) cut as `like` is, each rank's part a tensor of its own: the cut
    of the reduce-scatter. A leaf `like` holds whole stays the tensor it
    is."""
    return place(tree, like.specs, like.mesh, fsdp=True)


def _specs(shardings):
    if shardings is None:
        return None
    if isinstance(shardings, dict):
        return {k: _specs(v) for k, v in shardings.items()}
    if is_clustered(shardings):
        return shardings._replace(**{f: getattr(shardings, f).spec for f in CT_ARRAY_FIELDS
                                     if getattr(shardings, f) is not None})
    if _is_namedtuple(shardings):
        return type(shardings)(*(_specs(getattr(shardings, f)) for f in shardings._fields))
    return getattr(shardings, "spec", shardings)


def data_rows(mesh, n_slots: int) -> List[slice]:
    """The slot rows of each data rank: equal ranges where the "slots" rule
    cuts `n_slots` on the data axis, else every slot on every data rank
    (the divisibility fallback: each data rank runs the whole batch)."""
    n_data = mesh.shape["data"]
    with use_rules(mesh, fsdp=False):
        entry = logical_to_spec((n_slots,), ("slots",))[0]
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    if "data" not in axes:
        return [slice(None)] * n_data
    size = n_slots // n_data
    return [slice(d * size, (d + 1) * size) for d in range(n_data)]
