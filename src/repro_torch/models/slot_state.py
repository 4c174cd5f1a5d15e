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
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.autograd.profiler import record_function


def mask_slot_state(new: Dict[str, torch.Tensor], old: Dict[str, torch.Tensor],
                    active: torch.Tensor) -> None:
    """old[name] = where(active, new[name], old[name]) in place, per slot:
    leaves are (layers, slots, ...) and `active` is (slots,) bool. A slot
    past its request's token count keeps its rows bit for bit, and the
    tensors keep their identity."""
    with record_function("recurrent.mask_state"):
        for name, o in old.items():
            m = active.view((1, -1) + (1,) * (o.ndim - 2))
            torch.where(m, new[name].to(o.dtype), o, out=o)


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
