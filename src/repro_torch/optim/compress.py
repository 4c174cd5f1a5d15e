"""`allocate_bits` — the mixed-precision weight-bit allocator behind
`compress_model(bits_budget=...)`, ported from the JAX package's
`repro.optim.compress`: given per-layer empirical-Fisher sensitivity scores,
assign each layer a packing width in {2, 3, 4} so the element-weighted mean
stays under a global budget. Plain Python, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence


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
