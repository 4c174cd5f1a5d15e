"""Compression-side optimization utilities, ported from the JAX package's
`repro.optim.compress`:

1. `allocate_bits` — the mixed-precision weight-bit allocator behind
   `compress_model(bits_budget=...)`: given per-layer empirical-Fisher
   sensitivity scores, assign each layer a packing width in {2, 3, 4} so the
   element-weighted mean stays under a global budget. Plain Python, as in
   the reference.
2. Gradient compression with error feedback: int8 symmetric per-tensor
   quantization of each gradient, with a residual re-injected at the next
   step so the applied gradient stays unbiased over time (`EFState`,
   `apply_ef`; the train step's `grad_compress`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def allocate_bits(
    scores: Dict[str, float],          # layer -> Fisher sensitivity E[H·w²]
    sizes: Dict[str, int],             # layer -> element count
    budget: float,                     # element-weighted mean-bits cap
    widths: Sequence[int] = (2, 3, 4),
    floor: Optional[Dict[str, int]] = None,   # optional per-layer minimum width
) -> Dict[str, int]:
    """Greedy sensitivity-ordered demotion under a global bits budget.

    Every layer starts at the widest width. While the element-weighted mean
    exceeds `budget`, layers are demoted one width step (4 → 3 → 2) in
    ROUND-ROBIN passes over ascending sensitivity order: each pass visits
    every demotable layer once, least sensitive first, and stops the moment
    the budget holds. So the least-sensitive layers always sit at or below
    the width of more-sensitive ones — e.g. over equal-size layers a budget
    of 3.0 lands everyone at 3-bit (one full pass), while 2.5 sends the
    low-curvature half down to 2-bit and leaves the high-curvature half at
    3-bit.

    Deterministic (ties broken by path name). The result satisfies the
    budget whenever budget >= min(widths); a budget below the narrowest
    width raises.
    """
    if not scores:
        return {}
    ws = sorted(set(int(w) for w in widths))
    if budget < ws[0]:
        raise ValueError(
            f"bits budget {budget} is below the narrowest supported width "
            f"{ws[0]} — unsatisfiable")
    if set(scores) != set(sizes):
        raise ValueError("scores and sizes must cover the same layers")
    floor = floor or {}
    bits = {p: ws[-1] for p in scores}
    total = float(sum(sizes.values()))

    def mean_bits() -> float:
        return sum(bits[p] * sizes[p] for p in bits) / total

    order = sorted(scores, key=lambda p: (scores[p], p))
    # round-robin demotion: one width step per layer per pass, least
    # sensitive first, until the budget holds or no step remains
    while mean_bits() > budget + 1e-9:
        moved = False
        for p in order:
            lo = max(ws[0], floor.get(p, ws[0]))
            if bits[p] > lo:
                bits[p] = ws[ws.index(bits[p]) - 1]
                moved = True
                if mean_bits() <= budget + 1e-9:
                    break
        if not moved:
            break
    return bits


class EFState(NamedTuple):
    residual: Any          # same structure as the grads, f32; None = off


def init_ef(params) -> EFState:
    return EFState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def abstract_ef(aparams) -> EFState:
    """The EF state of an abstract parameter tree: f32 residuals on "meta"."""
    return EFState(tree_map(
        lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), aparams))


def compress_decompress(g: torch.Tensor, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (g + residual) to int8 with one absmax scale, return
    (dequantized in g's dtype, new f32 residual)."""
    return round_trip(g, r, torch.amax(torch.abs(g.to(torch.float32) + r)))


def round_trip(g: torch.Tensor, r: torch.Tensor, amax: torch.Tensor):
    """The int8 round trip of g + residual r under the scale amax / 127:
    (dequantized in g's dtype, new f32 residual). The train step on a mesh
    passes each part of a leaf the whole leaf's amax, so every element gets
    the bits the whole leaf's round trip gives it."""
    gf = g.to(torch.float32) + r
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    deq = q * scale
    return deq.to(g.dtype), gf - deq


def apply_ef(grads, ef: EFState):
    """(compressed grads, EFState of the new residuals), leaf by leaf."""
    out = [compress_decompress(g, r) for g, r in zip(leaves(grads), leaves(ef.residual))]
    return (unflatten(grads, [d for d, _ in out]),
            EFState(unflatten(ef.residual, [r for _, r in out])))
