"""Diagonal Hessian estimators for the LCD distillation objective (paper §3.2)
— the port of the JAX package's `repro.core.hessian`.

For a linear layer  Y = X @ W  (X: (n, d_in), W: (d_in, d_out)) with a quadratic
task-loss expansion, the layer-wise Hessian w.r.t. each output column of W is
H = 2 X^T X / n. LCD only needs diag(H):

    H_ii = 2 E[x_i^2]  (+ damping)

so one calibration pass collecting per-input-channel second moments suffices.
The same array doubles as the importance h in the weighted clustering
objective (Eq. 4) and as the preconditioner in the weight update (Eq. 5).
The empirical-Fisher variant (squared gradients) serves whole-model
compression, where layer inputs are inconvenient to capture.

The tensor functions run on their input's device; `ActivationStats` is a
host-side (numpy) collector, as in the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def diag_hessian_from_inputs(x: torch.Tensor, *, damp_frac: float = 1e-2) -> torch.Tensor:
    """diag(2 X^T X / n) + damping, from layer inputs x: (..., d_in) -> (d_in,).

    damp_frac follows GPTQ: damping is a fraction of the mean diagonal, which
    keeps the preconditioned update (Eq. 5) well-scaled for dead channels.
    """
    flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
    h = 2.0 * torch.mean(flat * flat, dim=0)
    damp = damp_frac * torch.mean(h) + 1e-12
    return h + damp


def diag_hessian_for_weight(x: torch.Tensor, w_shape, *, damp_frac: float = 1e-2) -> torch.Tensor:
    """Broadcast the per-input-channel diagonal to the full weight shape.

    Convention: weight matrices are stored (d_in, d_out); H_ii depends only on
    the input channel, so the result is h[:, None] broadcast to w_shape.
    """
    h = diag_hessian_from_inputs(x, damp_frac=damp_frac)
    w_shape = tuple(w_shape)
    if len(w_shape) == 2:
        if w_shape[0] != h.shape[0]:
            raise ValueError(f"weight {w_shape} does not take inputs of width {h.shape[0]}")
        return torch.broadcast_to(h[:, None], w_shape)
    if len(w_shape) == 3:  # stacked layers / experts: (E, d_in, d_out)
        if w_shape[1] != h.shape[0]:
            raise ValueError(f"weight {w_shape} does not take inputs of width {h.shape[0]}")
        return torch.broadcast_to(h[None, :, None], w_shape)
    raise ValueError(f"unsupported weight rank: {w_shape}")


def empirical_fisher(grads: torch.Tensor, *, damp_frac: float = 1e-2) -> torch.Tensor:
    """Empirical Fisher diag: E[g^2] over calibration batches, same shape as w."""
    f = grads.to(torch.float32) ** 2
    damp = damp_frac * torch.mean(f) + 1e-12
    return f + damp


def hessian_trace(h: torch.Tensor) -> torch.Tensor:
    """Trace of the diagonal approximation — the paper's progressive-optimization
    monitor ('sum the diagonal elements and use the Hessian Trace')."""
    return torch.sum(h)


class ActivationStats:
    """Streaming second-moment / absmax collector for calibration passes.

    Used by both the Hessian estimator and adaptive smoothing (they want the
    same calibration activations; one pass serves both). Tensors are copied
    to the host as they arrive.
    """

    def __init__(self) -> None:
        self._m2: Dict[str, np.ndarray] = {}
        self._amax: Dict[str, np.ndarray] = {}
        self._n: Dict[str, int] = {}

    def update(self, name: str, x) -> None:
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        x = np.asarray(x, np.float32).reshape(-1, x.shape[-1])
        m2 = (x * x).sum(axis=0)
        am = np.abs(x).max(axis=0)
        if name in self._m2:
            self._m2[name] += m2
            self._amax[name] = np.maximum(self._amax[name], am)
            self._n[name] += x.shape[0]
        else:
            self._m2[name] = m2
            self._amax[name] = am
            self._n[name] = x.shape[0]

    def diag_hessian(self, name: str, *, damp_frac: float = 1e-2) -> np.ndarray:
        h = 2.0 * self._m2[name] / max(self._n[name], 1)
        return h + damp_frac * h.mean() + 1e-12

    def amax(self, name: str) -> np.ndarray:
        return self._amax[name]

    def names(self):
        return list(self._m2)
