"""Adaptive smooth optimization (paper §3.4, Eq. 9) — the port of the JAX
package's `repro.core.smoothing`.

Activations of LLMs carry channel outliers that wreck low-bit uniform
quantization. Smoothing divides activations by a per-layer factor s and folds
the inverse into the weights: Y = (X / s) (s ⊙ W). LCD picks the factor
*offline* per layer, minimizing the INT8 quantization MSE of the smoothed
activations on a calibration set (Eq. 9):

    min_{s_m}  MSE(X,  Q_INT8(X / s_m) * s_m)

over a small family of candidates: scalar strengths (the paper's Table 3
settings 0.5 / 0.8, and others) and SmoothQuant-style per-channel vectors
s_j = amax_j^alpha normalised to a geometric mean of 1. The same family
calibrates the int8 KV cache (launch/engine.py calibrate_kv_smooth).

The offline search is numpy, as in the reference. The online transform
`smooth_quant_input` (Eq. 11) runs on the activation's device: the
`smooth_quant` kernel (kernels/csrc/smooth_quant.cu) on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.smooth_quant import smooth_quant


@dataclasses.dataclass
class SmoothResult:
    s: np.ndarray            # (d_in,) smoothing vector (may be constant)
    kind: str                # e.g. "scalar:0.8" or "alpha:0.5"
    mse: float               # Eq. 9 objective at the winner
    mse_identity: float      # objective with no smoothing (baseline)
    act_scale: float         # per-tensor symmetric int8 scale of smoothed acts


def _eq9_mse(x: np.ndarray, s: np.ndarray, bits: int = 8) -> Tuple[float, float]:
    """MSE(X, Q(X/s) * s) and the resulting per-tensor activation scale."""
    xs = x / s
    amax = np.abs(xs).max()
    scale = max(amax, 1e-12) / (2.0 ** (bits - 1) - 1)
    q = np.clip(np.round(xs / scale), -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1)
    xhat = q * scale * s
    return float(np.mean((x - xhat) ** 2)), float(scale)


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


def adaptive_smooth(
    x_calib: np.ndarray,
    *,
    bits: int = 8,
    scalars: Iterable[float] = (0.5, 0.8, 1.0, 1.5, 2.0),
    alphas: Iterable[float] = (0.25, 0.5, 0.65, 0.8),
) -> SmoothResult:
    """Pick the smoothing factor for one layer from calibration activations
    x_calib: (n_tokens, d_in)."""
    x = np.asarray(x_calib, np.float32).reshape(-1, x_calib.shape[-1])
    amax_c = np.abs(x).max(axis=0)
    best: Optional[SmoothResult] = None
    mse_id = None
    for kind, s in candidate_vectors(amax_c, scalars, alphas):
        mse, scale = _eq9_mse(x, s, bits)
        if kind == "identity":
            mse_id = mse
        if best is None or mse < best.mse:
            best = SmoothResult(s, kind, mse, 0.0, scale)
    best.mse_identity = mse_id
    return best


def fold_into_weight(w, s):
    """Smooth(W): scale weight rows by s so (X/s) @ (s*W) == X @ W.
    Convention: w is (d_in, d_out); s is (d_in,). numpy in, numpy out; a
    tensor is scaled on its device (the same float32 products)."""
    if isinstance(w, torch.Tensor):
        s = torch.as_tensor(np.asarray(s, np.float32) if not isinstance(s, torch.Tensor)
                            else s, device=w.device)
        return w.to(torch.float32) * s.to(torch.float32)[:, None]
    return (np.asarray(w, np.float32) * s[:, None]).astype(np.float32)


def smooth_quant_input(x: torch.Tensor, s: torch.Tensor, act_scale,
                       bits: int = 8) -> torch.Tensor:
    """Eq. 11: the smoothing divide and the quantization divide fuse into one
    multiply q = clip(round(X * inv_scale)), inv = 1/(s_m * s_q), computed in
    float32. Returns int8 codes of x's shape, clipped to [-2^(b-1), 2^(b-1)-1]
    (-128 included: the LUT kernels' ±127 contract is theirs, not this
    transform's). On a CUDA tensor it launches the smooth_quant kernel."""
    s = s.to(torch.float32)
    act = torch.as_tensor(act_scale, dtype=torch.float32, device=s.device)
    inv = (1.0 / (s * act)).contiguous()
    q = smooth_quant(x.reshape(-1, x.shape[-1]).contiguous(), inv, bits=bits)
    return q.reshape(x.shape)
