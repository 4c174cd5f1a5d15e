"""Collectives over the axis groups of a process mesh: the port's
counterpart of the collectives XLA inserts into the reference's SPMD
program.

On a process mesh (`launch/mesh.py ProcessMesh`: one torch.distributed
process per (data, model) coordinate, each holding only its own shards) a
value cut over an axis is combined by the processes of that axis's group:

  * `all_gather(t, group, dim)`: every member's `t`, concatenated on `dim`
    in rank order: exactly what `torch.cat` of the parts gives in one
    process (`distributed/sharding.py gather`);
  * `broadcast(t, group, src)`: member `src`'s `t` on every member;
  * `check_lockstep` / `check_same_tree`: every process's step tokens, or
    the digest of its weights, held against rank 0's;
  * `exchange_rows` / `row_writes`: the K / V rows a data rank writes into
    its pool replica this step, gathered over the data group so that every
    replica takes every data rank's writes (`models/layers.py _attend`).

The serving step needs no reduction: every projection is cut by its
output columns (`distributed/layout.py serving_names`), so a collective
here carries bytes only, viewed as uint8 whatever the dtype, and no bit of
a value can move.

The backend is the caller's choice (`init_process_mesh(backend=)`):
"nccl" where every rank has a card of its own, "gloo" on the CPU and where
ranks share one card. gloo's handling of CUDA tensors differs by PyTorch
version, so with gloo a CUDA tensor is staged through pinned host memory
here, always and explicitly: copied out, the collective run on the host
copy, the result copied back. `collective_counts()` reports the staged
calls beside the calls and bytes of every collective this process made
since `reset_collective_counts()`.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves

COLLECTIVES = ("all_gather", "broadcast")


@dataclasses.dataclass(frozen=True, eq=False)
class AxisGroup:
    """The processes that share this process's coordinates on every axis
    but one (or every process: the world): their global ranks in that
    axis's order, this process's index among them, the torch.distributed
    group (None where the group is this process alone) and its backend."""
    ranks: Tuple[int, ...]
    index: int
    pg: Any
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


def is_process_mesh(mesh) -> bool:
    """Whether `mesh` is served by one process per coordinate
    (`launch/mesh.py ProcessMesh`): it carries its axis groups."""
    return getattr(mesh, "groups", None) is not None


def _fresh_counts() -> Dict[str, Dict[str, int]]:
    return {name: {"calls": 0, "bytes": 0, "staged_calls": 0} for name in COLLECTIVES}


_COUNTS: Dict[str, Dict[str, int]] = _fresh_counts()


def collective_counts() -> Dict[str, Dict[str, int]]:
    """Per collective, this process's calls since the last reset, the bytes
    their results hold on this process (an all-gather's whole result, a
    broadcast's tensor) and how many of the calls were staged through host
    memory (gloo on a CUDA tensor)."""
    return {name: dict(c) for name, c in _COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.update(_fresh_counts())


def _count(name: str, nbytes: int, staged: bool) -> None:
    c = _COUNTS[name]
    c["calls"] += 1
    c["bytes"] += int(nbytes)
    c["staged_calls"] += int(staged)


def staged(group: AxisGroup, t: torch.Tensor) -> bool:
    """Whether a collective of `t` over `group` goes through host memory:
    gloo on a CUDA tensor."""
    return group.backend == "gloo" and t.is_cuda


def _wire(t: torch.Tensor, stage: bool) -> torch.Tensor:
    """`t`'s bytes as a flat uint8 tensor where the collective runs: on its
    device, or a pinned host copy."""
    flat = t.contiguous().view(-1).view(torch.uint8)
    if not stage:
        return flat
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(flat)
    return host


def all_gather(t: torch.Tensor, group: Optional[AxisGroup], dim: int = 0) -> torch.Tensor:
    """Every member's `t` (equal shapes and dtypes) concatenated on `dim` in
    the group's rank order, on `t`'s device; `t` itself where the group is
    this process alone."""
    if group is None or group.size == 1:
        return t
    import torch.distributed as dist
    stage = staged(group, t)
    wire = _wire(t, stage)
    parts = [torch.empty_like(wire) for _ in range(group.size)]
    dist.all_gather(parts, wire, group=group.pg)
    shape = tuple(t.shape)
    out = torch.cat([p.view(t.dtype).view(shape) for p in parts], dim=dim)
    _count("all_gather", out.numel() * out.element_size(), stage)
    return out.to(t.device) if stage else out


def broadcast(t: torch.Tensor, group: Optional[AxisGroup], src: int = 0) -> torch.Tensor:
    """Member `src`'s `t` (index in the group) on every member: a new tensor
    on `t`'s device of its shape and dtype; `t` itself where the group is
    this process alone."""
    if group is None or group.size == 1:
        return t
    import torch.distributed as dist
    stage = staged(group, t)
    wire = _wire(t, stage)
    if not stage:
        wire = wire.clone()             # the caller's tensor stays as it was
    dist.broadcast(wire, src=group.ranks[src], group=group.pg)
    out = wire.view(t.dtype).view(tuple(t.shape))
    _count("broadcast", out.numel() * out.element_size(), stage)
    return out.to(t.device) if stage else out


def check_lockstep(tokens: torch.Tensor, world: AxisGroup) -> torch.Tensor:
    """Rank 0's `tokens` (a step's next tokens) broadcast over the world,
    held against this process's own: every process runs the same host
    scheduler from the same submits, so they must agree; a process whose
    tokens differ raises. Returns `tokens`."""
    lead = broadcast(tokens, world, 0)
    if not torch.equal(lead, tokens):
        raise RuntimeError(
            f"process mesh out of lockstep: rank {world.ranks[world.index]}'s next tokens "
            f"{tokens.tolist()} differ from rank 0's {lead.tolist()}")
    return tokens


def tree_digest(tree) -> bytes:
    """SHA-256 over the tensors of `tree` (a tensor, or a tree of them) in
    tree order: each one's dtype, shape and bytes. Two trees of finite
    values are torch.equal leaf by leaf where their digests are equal."""
    h = hashlib.sha256()
    for x in leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.detach().contiguous().cpu()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.view(-1).view(torch.uint8).numpy())
    return h.digest()


def check_same_tree(tree, world: AxisGroup, what: str) -> None:
    """Every process's `tree_digest(tree)` all-gathered over the world
    (from the device of the tree's first tensor: NCCL takes CUDA tensors
    only) and held against rank 0's: every process of a process mesh must
    start from the same weights, which the lockstep check cannot see (the
    head runs whole on the gathered rows, so processes holding shards of
    different weights still agree on the tokens). Where any differs, every
    process raises, naming the ranks."""
    dev = next((x.device for x in leaves(tree) if isinstance(x, torch.Tensor)),
               torch.device("cpu"))
    mine = torch.tensor(list(tree_digest(tree)), dtype=torch.uint8, device=dev)
    every = all_gather(mine[None], world, 0)
    differ = [world.ranks[i] for i in range(world.size) if not torch.equal(every[i], every[0])]
    if differ:
        raise RuntimeError(f"process mesh: the {what} of rank(s) {differ} differ from rank "
                           f"0's (SHA-256 of every tensor)")


# ---------------------------------------------------------------------------
# The pool replicas' write exchange
# ---------------------------------------------------------------------------

_ROW_GROUP: contextvars.ContextVar = contextvars.ContextVar("row_exchange", default=None)


@contextlib.contextmanager
def exchange_rows(group: Optional[AxisGroup]) -> Iterator[None]:
    """Inside, every pool write goes to this process's replica from every
    member of `group` (the data group of a step whose slots the data ranks
    split): `row_writes` gathers them."""
    tok = _ROW_GROUP.set(group)
    try:
        yield
    finally:
        _ROW_GROUP.reset(tok)


def row_writes(idx: torch.Tensor, valid: torch.Tensor, vals: Sequence[torch.Tensor]
               ) -> List[Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]]:
    """(idx, valid, vals) of every data rank's writes this layer, in rank
    order: this process's alone outside `exchange_rows`, else each member's,
    gathered (every member writes as many rows: the data ranks hold equal
    slot ranges)."""
    group = _ROW_GROUP.get()
    if group is None or group.size == 1:
        return [(idx, valid, list(vals))]
    n = group.size
    gathered = [all_gather(t, group, 0).chunk(n, dim=0) for t in (idx, valid, *vals)]
    return [(gathered[0][r], gathered[1][r], [g[r] for g in gathered[2:]]) for r in range(n)]
