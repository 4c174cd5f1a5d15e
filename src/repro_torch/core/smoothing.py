"""Smoothing candidates of the paper's Eq. 9 (§3.4).

Smoothing divides activations by a per-channel factor s and folds the inverse
into whatever consumes them. The calibration searches a small family of
candidates and keeps the one with the least int8 round-trip error:

  - scalar strengths (the paper's Table 3 settings 0.5 / 0.8, and others), and
  - SmoothQuant-style per-channel vectors s_j = amax_j^alpha, normalised to a
    geometric mean of 1.

The port uses the family for the int8 KV cache (launch/engine.py
calibrate_kv_smooth); the layer-wise search of the compression pipeline is
not ported yet. Plain numpy, as in the JAX package's core/smoothing.py.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np


def candidate_vectors(
    amax_per_channel: np.ndarray,
    scalars: Iterable[float] = (0.5, 0.8, 1.0, 1.5, 2.0),
    alphas: Iterable[float] = (0.25, 0.5, 0.65, 0.8),
) -> List[Tuple[str, np.ndarray]]:
    """(kind, vector) candidates for one layer, identity first."""
    d = amax_per_channel.shape[0]
    cands: List[Tuple[str, np.ndarray]] = [("identity", np.ones(d, np.float32))]
    for sm in scalars:
        cands.append((f"scalar:{sm}", np.full(d, sm, np.float32)))
    a = np.maximum(amax_per_channel.astype(np.float64), 1e-8)
    for al in alphas:
        v = a ** al
        v = v / np.exp(np.mean(np.log(v)))  # geo-mean normalize -> scale-free
        cands.append((f"alpha:{al}", v.astype(np.float32)))
    return cands
