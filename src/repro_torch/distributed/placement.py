"""Placement: a parameter tree, a ClusteredTensor, a KV pool cut into one
shard per (data, model) mesh coordinate, from the specs of
`distributed/sharding.py`.

The JAX package commits its trees to a mesh with `jax.device_put(tree,
shardings)` and lets GSPMD partition every step. The port serves a mesh from
one process over one repeated device: `place` cuts each leaf on the dim its
spec gives the model axis (a contiguous tensor per model rank), and every
data rank holds those same tensors, so its replicas cost no memory; a leaf
left whole (and a model axis of 1) is the caller's tensor where it already
lies on the mesh's device. A mesh of distinct cards is refused: it waits for
a multi-process torch.distributed backend.

  * a ClusteredTensor's `codes` and `packed` are cut on the dense weight's
    cut dim; a cut along K must fall on whole 8-channel k-blocks (the
    packing group of the LUT kernels, kernels/csrc/lut_common.cuh);
    `smooth` and `inv_scale` are cut like the input dims; `codebook` and
    `act_scale` stay whole;
  * a pool is cut on `kv`: each model rank holds its kv-head shard of every
    block, so block tables stay valid everywhere; the data ranks write their
    slots' rows into the same parts.

The result is a `MeshTree`: one tree per data rank whose cut leaves are
`Sharded` (parts per model rank) and whose whole leaves are plain tensors on
that data rank's first device (pool leaves are always `Sharded`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.api import CT_ARRAY_FIELDS, is_clustered, map_arrays
from repro_torch.distributed.sharding import Sharded, logical_to_spec, use_rules
from repro_torch.launch.mesh import require_one_device

# input channels of one k-block: the packing group of every width
K_BLOCK = 8


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
    return [tree] if isinstance(tree, torch.Tensor) else []


def _map_leaves(tree, fn):
    if isinstance(tree, Sharded):
        return tree.map(lambda p: _map_leaves(p, fn))
    if is_clustered(tree):
        return map_arrays(tree, fn)
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _model_dim(spec, what: str) -> Optional[int]:
    """The dim `spec` cuts on the model axis (None: whole). A cut on the
    data or pod axis (FSDP) is refused: training on a mesh waits."""
    dim = None
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if any(a != "model" for a in axes):
            raise NotImplementedError(
                f"place: {what} is cut on {axes}; only the model axis cuts a "
                f"parameter or a pool when serving (FSDP waits for training on a mesh)")
        if axes:
            dim = i
    return dim


def _cut(x: torch.Tensor, dim: Optional[int], m: int) -> List[torch.Tensor]:
    if dim is None:
        return [x] * m
    size = x.shape[dim] // m
    return [x.narrow(dim, i * size, size).contiguous() for i in range(m)]


def _cut_clustered(ct, shardings, m: int, what: str):
    """(parts, cut dim of the dense weight) of a ClusteredTensor."""
    fields: Dict[str, List] = {}
    dims: Dict[str, Optional[int]] = {}
    for f in CT_ARRAY_FIELDS:
        arr, ns = getattr(ct, f), getattr(shardings, f)
        if arr is None:
            continue
        dims[f] = _model_dim(ns.spec, f"{what}.{f}")
        fields[f] = _cut(arr, dims[f], m)
    dim = dims["codes"]
    d_in = ct.smooth.shape[-1]
    if dim is not None and dim == ct.codes.ndim - 2 and (d_in // m) % K_BLOCK:
        raise ValueError(
            f"place: {what} is cut along K (d_in {d_in}) into {m} parts of "
            f"{d_in // m} channels; a cut must fall on whole {K_BLOCK}-channel k-blocks")
    parts = [ct._replace(**{f: v[i] for f, v in fields.items()}) for i in range(m)]
    return parts, dim


def place(tree, shardings, mesh, *, writable: bool = False) -> MeshTree:
    """Cut `tree` (nested dicts of tensors and ClusteredTensors) by
    `shardings` (the matching tree of NamedShardings, `auto_shard` /
    `cache_shardings`) onto `mesh` (axes "data" and "model"), whose devices
    must repeat (`launch/mesh.py require_one_device`). Each part is moved to
    the mesh's device once and every data rank's view holds that same
    tensor. `writable` marks a tree the step writes (a pool): its leaves are
    always `Sharded`, so a write by one data rank is what every other
    reads."""
    require_one_device(mesh, "place")
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    dev = mesh.lead_device

    def to(x):
        if is_clustered(x):
            return map_arrays(x, to)
        return x.to(dev)

    def one(x, ns, what):
        if is_clustered(x):
            parts, dim = _cut_clustered(x, ns, n_model, what)
        else:
            dim = _model_dim(ns.spec, what)
            parts = _cut(x, dim, n_model)
        parts = [to(p) for p in parts] if dim is not None else [to(x)] * n_model
        leaf = Sharded(tuple(parts), dim) if dim is not None or writable else parts[0]
        return [leaf] * n_data

    def walk(x, ns, what):
        if isinstance(x, dict):
            got = {k: walk(x[k], ns[k], f"{what}/{k}" if what else k) for k in x}
            return [{k: v[d] for k, v in got.items()} for d in range(n_data)]
        return one(x, ns, what)

    views = walk(tree, shardings, "")
    specs = _specs(shardings)
    return MeshTree(mesh, tuple(views), specs)


def _specs(shardings):
    if isinstance(shardings, dict):
        return {k: _specs(v) for k, v in shardings.items()}
    if is_clustered(shardings):
        return shardings._replace(**{f: getattr(shardings, f).spec for f in CT_ARRAY_FIELDS
                                     if getattr(shardings, f) is not None})
    return shardings.spec


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
