"""Sharding rules: logical axis names -> mesh axes, with divisibility safety,
and the layout of a value cut over a mesh's model axis.

The framework names activation and parameter dimensions logically ("batch",
"vocab", "heads", "kv", "ff", "embed", "experts", ...) and this module maps
them onto physical mesh axes, as the JAX package's `distributed/sharding.py`
does, with the same rules and the same names:

    batch   -> ("pod", "data")     # data parallel (+ the pod axis)
    vocab/ff/heads/kv/experts/q_dim -> "model"   # tensor / expert parallel
    embed   -> ("pod", "data")     # FSDP of the d_model dim of weights
    seq     -> None                # activations keep seq whole

Every mapping is divisibility-checked against the mesh: a dimension that
the axis product does not divide falls back to a shrinking suffix of the
compound axis, then to whole (qwen2's 12 query heads on a 16-way model axis
stay whole while its MLP still cuts), and an axis is used by one dim only.

`logical_to_spec(shape, names, sr)` is the single entry; `auto_shard`
decorates whole parameter trees, a ClusteredTensor's six fields included.
A spec is a `PartitionSpec`: one entry per dim, None, an axis name or a
tuple of names.

The port serves and trains on a mesh from one process (`launch/mesh.py`):
every model rank's shard is a tensor of its own on its rank's device
(`Sharded`), and its step runs each rank's part and combines the parts
where the layout says. `maybe_shard` is that point: the JAX package's sharding constraint,
which here gathers a cut activation (the parts concatenated in rank order)
where the names leave its dim whole. On a process mesh (one process per
coordinate, `launch/mesh.py ProcessMesh`) a `Sharded` holds this process's
part alone and the axis group it is cut over, and the same points combine
the parts with an all-gather over that group (`distributed/collectives.py`),
concatenated in rank order as in one process.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Axis = Union[None, str, Tuple[str, ...]]

# logical name -> mesh axes (in priority order); the JAX package's table
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,                 # activations keep seq unsharded by default
    # KV-cache sequence dim: takes whatever axes the batch dim left unused
    "seq_kv": ("pod", "data", "model"),
    "embed": ("pod", "data"),    # FSDP dim of params
    "embed_nofsdp": None,
    # continuous-batching serving engine: request slots shard like a batch
    # dim; the physical block pool stays whole on the data axis (each rank
    # holds its kv-head shard of EVERY block, so a slot's block table is
    # valid on every rank without any re-mapping)
    "slots": ("pod", "data"),
    "blocks": None,
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "kv_flat": "model",
    "q_dim": "model",
    "ff": "model",
    "experts": "model",
    "ssm_heads": "model",
    "ssm_inner": "model",
    "ssm_in": None,
    "rwkv_heads": "model",
    "layers": None,
    "conv": None,
    "state": None,
    # hybrid pools' shared-attention-site dim and the encoder-decoder's
    # frame dim: "slots" already takes the data axes and "kv" the model
    # axis, so these dims have no axes left to claim
    "sites": None,
    "enc_seq": None,
}


class PartitionSpec(tuple):
    """One entry per dim: None (whole), an axis name, or a tuple of names
    (the JAX package's `jax.sharding.PartitionSpec`)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the JAX package's `jax.sharding.NamedSharding`)."""
    mesh: Any
    spec: PartitionSpec


_rules_ctx: contextvars.ContextVar = contextvars.ContextVar("sharding_rules", default=None)


@dataclasses.dataclass
class ShardingRules:
    mesh: Any                    # anything with a `.shape` {axis: size} mapping
    rules: Dict[str, Axis]
    fsdp: bool = True            # False: drop the "embed" FSDP sharding (serve mode)

    def axis_size(self, axis: Axis) -> int:
        if axis is None:
            return 1
        axes = (axis,) if isinstance(axis, str) else axis
        size = 1
        for a in axes:
            size *= self.mesh.shape.get(a, 1)
        return size


@contextlib.contextmanager
def use_rules(mesh, overrides: Optional[Dict[str, Axis]] = None, *, fsdp: bool = True):
    rules = dict(DEFAULT_RULES)
    if not fsdp:
        rules["embed"] = None
    if overrides:
        rules.update(overrides)
    tok = _rules_ctx.set(ShardingRules(mesh, rules, fsdp))
    try:
        yield
    finally:
        _rules_ctx.reset(tok)


def current_rules() -> Optional[ShardingRules]:
    return _rules_ctx.get()


def logical_to_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                    sr: Optional[ShardingRules] = None) -> PartitionSpec:
    """A PartitionSpec for `shape` from logical dim names, dropping any
    mapping whose axis size does not divide the dimension."""
    sr = sr or current_rules()
    if sr is None:
        return P()
    assert len(shape) == len(names), (shape, names)
    out = []
    used: set = set()
    for dim, name in zip(shape, names):
        axis = sr.rules.get(name) if name else None
        if axis is None:
            out.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        # drop axes already used by an earlier dim (an axis cuts one dim only)
        axes = tuple(a for a in axes if a not in used and a in sr.mesh.shape)
        size = int(np.prod([sr.mesh.shape[a] for a in axes])) if axes else 1
        if size > 1 and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            # a shrinking suffix (("pod", "data") -> ("data",)) before giving up
            placed = False
            for start in range(1, len(axes)):
                sub = axes[start:]
                s = int(np.prod([sr.mesh.shape[a] for a in sub]))
                if s > 1 and dim % s == 0:
                    out.append(sub if len(sub) > 1 else sub[0])
                    used.update(sub)
                    placed = True
                    break
            if not placed:
                out.append(None)
    return P(*out)


def named_sharding(shape: Sequence[int], names: Sequence[Optional[str]],
                   sr: Optional[ShardingRules] = None) -> Optional[NamedSharding]:
    sr = sr or current_rules()
    if sr is None:
        return None
    return NamedSharding(sr.mesh, logical_to_spec(shape, names, sr))


def parse_names(names: str) -> Tuple[Optional[str], ...]:
    """'layers,embed,ff' -> ('layers','embed','ff'); '.' = a whole dim;
    '' = a scalar (rank 0)."""
    if names == "":
        return ()
    return tuple(None if n in (".", "") else n for n in names.split(","))


def _map_tree(fn, tree, names, is_clustered):
    """fn(leaf, names-string) over a params tree and its names tree (nested
    dicts; a ClusteredTensor is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k], names[k], is_clustered) for k in tree}
    return fn(tree, names)


def auto_shard(tree, tree_names, sr: Optional[ShardingRules] = None):
    """NamedShardings for a whole (possibly LCD-compressed) parameter tree.

    `tree_names` is the DENSE tree's names (comma-joined strings,
    `Model.names()`); a ClusteredTensor leaf gets a ClusteredTensor of
    shardings, one per field:

      codes / packed -> the dense weight's names (packed rows are
                        d_in·nbits/8; the divisibility fallback keeps them
                        whole when the model axis stops dividing);
      smooth / inv_scale -> the names minus the output dim (they are (d_in,)
                        vectors, (L, d_in) when stacked);
      codebook / act_scale -> whole (tiny).

    Returns a tree of the same structure as `tree` (None fields stay None)."""
    sr = sr or current_rules()
    assert sr is not None, "auto_shard needs a rules context (use_rules) or sr"
    from repro_torch.core.api import is_clustered

    def clustered(ct, nm: Tuple[Optional[str], ...]):
        vec_nm = nm[:-1]             # smoothing vectors live on the d_in dims

        def ns(arr, names):
            if arr is None:
                return None
            return named_sharding(arr.shape, names, sr)

        return type(ct)(
            codes=ns(ct.codes, nm),
            codebook=ns(ct.codebook, (None,) * ct.codebook.ndim),
            smooth=ns(ct.smooth, vec_nm),
            packed=ns(ct.packed, nm),
            inv_scale=ns(ct.inv_scale, vec_nm),
            act_scale=(None if ct.act_scale is None
                       else ns(ct.act_scale, (None,) * ct.act_scale.ndim)),
            nbits=ct.nbits,
        )

    def one(leaf, names: str):
        nm = parse_names(names)
        if is_clustered(leaf):
            return clustered(leaf, nm)
        return named_sharding(leaf.shape, nm, sr)

    return _map_tree(one, tree, tree_names, is_clustered)


def tree_shardings(tree_shapes, tree_names, sr: Optional[ShardingRules] = None):
    """NamedShardings for a tree of tensors (real or on the "meta" device)
    and a matching tree of comma-joined logical-name strings."""
    sr = sr or current_rules()
    assert sr is not None

    def one(x, names: str):
        return named_sharding(tuple(x.shape), parse_names(names), sr)

    return _map_tree(one, tree_shapes, tree_names, lambda x: False)


# ---------------------------------------------------------------------------
# A value cut over one mesh axis, and the point where its parts combine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor (or ClusteredTensor) cut over one mesh axis, as one process
    holds it: `parts[i]` is rank i's part on that rank's device, cut on
    `dim` of the whole (None: every part is the whole). On a process mesh
    `group` is the axis group (`distributed/collectives.py AxisGroup`) and
    `parts` holds this process's part alone."""
    parts: Tuple[Any, ...]
    dim: Optional[int]
    axis: str = "model"
    group: Any = None

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def ranks(self) -> int:
        """The ranks the value is cut over (the parts held, or the group's
        processes)."""
        return len(self.parts) if self.group is None else self.group.size

    def with_parts(self, parts: Sequence[Any], dim: Optional[int]) -> "Sharded":
        """`parts` (one per part held) cut on `dim`, over this value's axis
        and group."""
        return Sharded(tuple(parts), dim, self.axis, self.group)

    def map(self, fn, dims_dropped: int = 0) -> "Sharded":
        """`fn` on every part; `dims_dropped` leading dims indexed away (a
        layer slice)."""
        dim = None if self.dim is None else self.dim - dims_dropped
        return self.with_parts([fn(p) for p in self.parts], dim)


def device_of(x) -> torch.device:
    """The device a tensor or a ClusteredTensor lies on."""
    return x.device if isinstance(x, torch.Tensor) else x.codebook.device


def gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The parts concatenated on `dim` in rank order, on the first part's
    device (the combine of a cut activation: an all-gather)."""
    dev = parts[0].device
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def whole(x):
    """The whole value of a `Sharded` (its parts gathered, or its first part
    where every part is the whole; on a process mesh, all-gathered over its
    group); anything else as it is."""
    if not isinstance(x, Sharded):
        return x
    if x.dim is None:
        return x.parts[0]
    if x.group is not None:
        from repro_torch.distributed.collectives import all_gather
        return all_gather(x.parts[0], x.group, x.dim)
    return gather(x.parts, x.dim)


def parts_on(x, n: int, dim: int) -> List[torch.Tensor]:
    """`x` as `n` equal parts on `dim`, in rank order: a `Sharded` x cut on
    that dim in n parts gives its own parts; anything else is made whole and
    narrowed (views). n = 1 gives [whole(x)]."""
    if isinstance(x, Sharded) and x.dim is not None and x.group is None and len(x.parts) == n:
        nd = x.parts[0].ndim
        if x.dim % nd == dim % nd:
            return list(x.parts)
    w = whole(x)
    if n == 1:
        return [w]
    size = w.shape[dim] // n
    return [w.narrow(dim, i * size, size) for i in range(n)]


def rank_parts(x) -> List[Any]:
    """The distinct parts of a value a model rank computes on: a cut
    `Sharded`'s parts, a whole one's single tensor, a plain value alone."""
    if not isinstance(x, Sharded):
        return [x]
    return list(x.parts) if x.dim is not None else [x.parts[0]]


def like(x, parts: Sequence[Any]):
    """`parts` (one per `rank_parts(x)`) wrapped as `x` is: a `Sharded` with
    x's cut (a whole one's single part repeated), or the one part."""
    if not isinstance(x, Sharded):
        return parts[0]
    if x.dim is None:
        return x.with_parts((parts[0],) * len(x.parts), None)
    return x.with_parts(parts, x.dim)


def on_parts(x, fn, dims_dropped: int = 0):
    """`fn` on every part of a `Sharded` x (`Sharded.map`), or on x."""
    return x.map(fn, dims_dropped) if isinstance(x, Sharded) else fn(x)


def maybe_shard(x, *names: Optional[str]):
    """Constrain activation `x` to the layout the logical `names` give on the
    installed rules' mesh: the point where a step's parts combine. A
    `Sharded` x whose cut dim the names leave whole (or cut on another
    axis) is gathered, its parts concatenated in rank order on the first
    part's device; anything else is returned as it is. Without a rules
    context (one device) x is a tensor and this is the identity."""
    if not isinstance(x, Sharded) or x.dim is None:
        return whole(x)
    sr = current_rules()
    full = list(x.parts[0].shape)
    full[x.dim] = sum(p.shape[x.dim] for p in x.parts) * (x.ranks // len(x.parts))
    keep = False
    if sr is not None:
        entry = logical_to_spec(full, names, sr)[x.dim]
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        keep = x.axis in axes and sr.mesh.shape.get(x.axis, 1) == x.ranks
    return x if keep else whole(x)
