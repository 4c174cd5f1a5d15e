"""Shared helpers of the SlotStateCache serving steps (rwkv6, gla, zamba2).

Slot-state leaves put the slot axis at position 1 — (layers, slots, ...) —
mirroring the paged pools' (layers, blocks, ...) layout, so the engine's
per-slot reset, snapshot and restore are one indexing rule for every family.

Recurrent families serve a (slots, T) token window by stepping one token at
a time: every token runs the exact sequential recurrence (the chunked forms
of `linear_attn.py` need more than one token and never run here), so the
engine's tokens are those of solo token-by-token decoding by construction.

UNLIKE the JAX package, which returns new state arrays, the state is updated
IN PLACE: the engine's CUDA graphs read the state tensors they were captured
over, so no step may replace one.

A family's engine step is its trunk (the token passes: each slot's hidden
row at its last valid token) and its head (the final norm and the vocab
product), joined by `slot_serving_step`.

On a serving mesh (`launch/engine.py ServingEngine(mesh=)`) a state leaf is
a `distributed/sharding.py Sharded`, cut by heads (or by inner channels)
over the model axis, or whole: each model rank runs the recurrence over its
heads (`per_head_ranks`), every other op of the step runs whole on
gathered values, as on one device, and `mesh_state_step` runs each data
rank over its slots' rows of the shared state tensors. On a training mesh
(`launch/steps.py build_train_step` on a placed state) the full-sequence
forward's mixers run the same way from a whole zero state: each model rank
over its heads (`per_head_ranks`) from its slice of the state.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch.autograd.profiler import record_function

from repro_torch.distributed.placement import MeshTree, data_rows
from repro_torch.distributed.sharding import (Sharded, like, maybe_shard, on_parts, parts_on,
                                              rank_parts, use_rules)


def mask_slot_state(new: Dict[str, torch.Tensor], old: Dict[str, torch.Tensor],
                    active: torch.Tensor) -> None:
    """old[name] = where(active, new[name], old[name]) in place, per slot:
    leaves are (layers, slots, ...) and `active` is (slots,) bool. A slot
    past its request's token count keeps its rows bit for bit, and the
    tensors keep their identity. A `Sharded` old leaf is written part by
    part (a whole one once), from new's parts of the same cut (or a whole
    new)."""
    with record_function("recurrent.mask_state"):
        for name, o in old.items():
            olds = rank_parts(o)
            news = rank_parts(new[name]) if isinstance(new[name], Sharded) else [new[name]]
            for nw, op in zip(news, olds):
                m = active.view((1, -1) + (1,) * (op.ndim - 2))
                torch.where(m, nw.to(op.dtype), op, out=op)


def state_layer(leaf, l: int):
    """Layer l of a stacked state leaf, kept as (1, slots, ...) views."""
    return on_parts(leaf, lambda t: t[l:l + 1])


def state_first(leaf):
    """The (slots, ...) rows of a (1, slots, ...) `state_layer` view."""
    return on_parts(leaf, lambda t: t[0], dims_dropped=1)


def per_head_ranks(fn: Callable, state, inputs: Sequence, dims: Sequence, out_dim: int = 2,
                   *, state_dim: int = 1, heads: Optional[int] = None):
    """A mixer over each model rank's heads: `state` is a state leaf (or a
    tuple of leaves) cut by heads (`Sharded`: a serving mesh's slot state),
    whose `rank_parts` give the ranks, or whole (a tensor, or None: the
    full-sequence forward's zero state), which runs over the ranks of the
    first of `inputs` cut over the model axis (a projection's output, which
    `linear` cuts by columns, or a param cut by heads) where they divide the
    heads (`heads`, else the state's size on `state_dim`; with neither, the
    cut input's parts are the units) and else once, whole; each rank starts
    from its slice of a whole state on `state_dim` (None stays None). Each
    of `inputs` is cut into as many parts on its dim in `dims` (`parts_on`:
    a value already cut there keeps its parts; a whole one is narrowed).
    fn(*rank's inputs, *rank's state parts) -> (y, new state part or None)
    runs once a rank, in rank order. Returns (the ys concatenated on
    `out_dim`, the new parts wrapped as `state` is, or concatenated on
    `state_dim` for a whole state, or None). On one device it is fn once."""
    states = state if isinstance(state, tuple) else (state,)
    if isinstance(states[0], Sharded):
        sparts = [rank_parts(t) for t in states]
        n = len(sparts[0])
    else:
        n = next((len(x.parts) for x in inputs
                  if isinstance(x, Sharded) and x.dim is not None), 1)
        if heads is None and states[0] is not None:
            heads = states[0].shape[state_dim]
        if heads is not None and heads % n:
            n = 1
        sparts = [[None] * n if t is None else parts_on(t, n, state_dim) for t in states]
    ins = [parts_on(x, n, dim) for x, dim in zip(inputs, dims)]
    ys, news = [], []
    for m in range(n):
        y, new = fn(*(x[m] for x in ins), *(t[m] for t in sparts))
        ys.append(y)
        news.append(new)
    y = ys[0] if n == 1 else torch.cat(ys, dim=out_dim)
    if news[0] is None:
        return y, None
    if n > 1 and not isinstance(states[0], Sharded):
        return y, torch.cat(news, dim=state_dim)
    return y, like(states[0], news)


def token_by_token(state_step: Callable) -> Callable:
    """A recurrent family's trunk from its one-token step `state_step(params,
    state, tok (slots, 1), active (slots,), cfg)` -> hidden rows (slots, 1,
    d): the (slots, T) window one token at a time, so that every token runs
    the exact sequential recurrence and a slot's rows past its n_new keep
    their state. Returns each slot's hidden row (before the final norm) at
    its last valid token, (slots, d). `lengths` and `block_tables` are
    unused: the recurrence has no positions and no pages."""
    def trunk(params, caches, tokens, lengths, n_new, block_tables, cfg):
        del lengths, block_tables
        xs = [state_step(params, caches["slot"], tokens[:, t:t + 1], t < n_new, cfg)[:, 0]
              for t in range(tokens.shape[1])]
        return gather_last_logits(torch.stack(xs), n_new)
    return trunk


def slot_serving_step(trunk: Callable, head: Callable) -> Callable:
    """A slot-state family's engine step from its `trunk(params, caches,
    tokens, lengths, n_new, block_tables, cfg)` -> (slots, d) and its
    `head(params, x, cfg)` -> (slots, padded_vocab): head(trunk(...)) on one
    device, `mesh_state_step` on a mesh. Returns (the logits at each slot's
    last valid token, `caches`), whose state was updated in place."""
    @torch.no_grad()
    def step(params, caches, tokens, lengths, n_new, block_tables, cfg):
        args = (params, caches, tokens, lengths, n_new, block_tables, cfg)
        if isinstance(params, MeshTree):
            return mesh_state_step(trunk, head, *args), caches
        return head(params, trunk(*args), cfg), caches
    return step


def mesh_state_step(trunk, head, params: MeshTree, caches, tokens, lengths, n_new,
                    block_tables, cfg) -> torch.Tensor:
    """A slot-state family's step on a (data, model) mesh, from one process:
    each data rank runs `trunk(params, caches, tokens, lengths, n_new,
    block_tables, cfg)` over its slots (`data_rows`) on its tree of shards
    and its slots' rows of the slot state (the data ranks share the state's
    tensors, and a pool's); the rows it returns are gathered in rank order
    and `head(params, rows, cfg)` runs ONCE over every slot's row, as on one
    device. Where the slots do not divide over the data axis, data rank 0
    runs every slot alone: a recurrent state must advance once a token."""
    mesh = params.mesh
    rows_all = data_rows(mesh, tokens.shape[0])
    if rows_all[0] == slice(None):
        rows_all = rows_all[:1]
    outs = []
    with use_rules(mesh, fsdp=False):
        for d, rows in enumerate(rows_all):
            dev = mesh.device_at(data=d)
            view = {kind: ({name: on_parts(leaf, lambda t: t[:, rows])
                            for name, leaf in c.views[d].items()} if kind == "slot"
                           else c.views[d]) for kind, c in caches.items()}
            args = [a[rows].to(dev) for a in (tokens, lengths, n_new, block_tables)]
            outs.append(trunk(params.views[d], view, *args, cfg))
        x = outs[0] if len(outs) == 1 else maybe_shard(
            Sharded(tuple(outs), 0, axis="data"), *[None] * outs[0].ndim)
    return head(params.views[0], x, cfg)


def gather_last_logits(x_tsv: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
    """Stacked per-token rows (T, slots, ...) -> each slot's row at its last
    valid position (slots, ...); an inactive slot (n_new == 0) reads position
    0. The JAX package gathers logits; the port's steps gather the final
    hidden rows and apply the vocab head once to the gathered (slots, d)
    rows, which gives a slot the same bits (the head is one product over the
    same number of rows either way) for one head product a step instead of
    T."""
    idx = torch.clamp(n_new - 1, min=0).long()
    slots = torch.arange(x_tsv.shape[1], device=x_tsv.device)
    return x_tsv[idx, slots]
