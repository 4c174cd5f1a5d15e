"""Uniform quantizers + PTQ baselines (RTN, GPTQ) used by LCD and its
comparisons — the port of the JAX package's `core/quantize.py`.

LCD itself quantizes *activations* with uniform symmetric int8/int4 (paper
Eq. 10-11) and clusters *weights*; the uniform weight quantizers here are
the baselines of Table 2 (GPTQ, RTN) and Fig. 2's clustering-vs-quantization
MSE comparison. The activation quantizers work on tensors on any device;
RTN, GPTQ and Fig. 2 are float64 numpy on the host, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Uniform symmetric quantization (activations; paper Eq. 10)
# ---------------------------------------------------------------------------

def sym_scale(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """Scale mapping [-amax, amax] onto the symmetric integer grid."""
    qmax = 2.0 ** (bits - 1) - 1
    return torch.clamp(torch.as_tensor(amax), min=1e-12) / qmax


def quantize_sym(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """q = clip(round(x / scale)) in [-2^{b-1}, 2^{b-1}-1] (Eq. 10). int8 storage."""
    qmin = -(2.0 ** (bits - 1))
    qmax = 2.0 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x / scale), qmin, qmax)
    return q.to(torch.int8)


def dequantize_sym(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant_sym(x: torch.Tensor, bits: int, *, axis: Optional[int] = None) -> torch.Tensor:
    """Quant-dequant roundtrip with per-tensor (axis=None) or per-axis absmax
    scale. Used by the smoothing search (Eq. 9) and activation-quant
    ablations."""
    if axis is None:
        amax = torch.amax(torch.abs(x))
    else:
        amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    s = sym_scale(amax, bits)
    return dequantize_sym(quantize_sym(x, s, bits), s)


# ---------------------------------------------------------------------------
# RTN weight baseline
# ---------------------------------------------------------------------------

def rtn_weight(w: np.ndarray, bits: int, *, per_channel: bool = True) -> np.ndarray:
    """Round-to-nearest b-bit symmetric weight quantization (dequantized result)."""
    w = np.asarray(w, np.float32)
    qmax = 2.0 ** (bits - 1) - 1
    if per_channel and w.ndim == 2:
        amax = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-12)
    else:
        amax = np.maximum(np.abs(w).max(), 1e-12)
    s = amax / qmax
    q = np.clip(np.round(w / s), -qmax - 1, qmax)
    return (q * s).astype(np.float32)


# ---------------------------------------------------------------------------
# GPTQ baseline (Frantar et al., 2022) — honest second-order PTQ comparison
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GPTQResult:
    w_q: np.ndarray        # dequantized quantized weights, same shape as w
    err_frob: float        # ||W - W_q||_F
    err_hessian: float     # trace(dW^T H dW) — the objective GPTQ minimizes


def gptq_quantize(
    w: np.ndarray,
    hessian: np.ndarray,
    bits: int,
    *,
    blocksize: int = 128,
    percdamp: float = 0.01,
    centroids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """GPTQ: column-wise quantization with Cholesky-propagated error compensation.

    w       : (d_in, d_out) float — each column quantized against H = 2 X^T X (d_in, d_in).
    centroids: optional codebook — if given, 'quantization' snaps to the nearest
               centroid instead of the uniform grid. This gives the *GPTQ+clustering*
               hybrid used as an extra ablation (and mirrors SKIM's scaled-kmeans
               when centroids come from kmeans).
    """
    w = np.asarray(w, np.float64).copy()
    d_in, d_out = w.shape
    H = np.asarray(hessian, np.float64).copy()
    assert H.shape == (d_in, d_in)

    dead = np.diag(H) == 0
    H[dead, dead] = 1.0
    w[dead, :] = 0.0

    damp = percdamp * np.mean(np.diag(H))
    H[np.diag_indices(d_in)] += damp

    # Inverse via Cholesky of H^-1 (upper), as in the reference implementation.
    Hinv = np.linalg.inv(H)
    L = np.linalg.cholesky(Hinv)      # lower
    Hinv_chol = L.T                    # upper triangular, Hinv = L L^T

    if centroids is None:
        qmax = 2.0 ** (bits - 1) - 1
        amax = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-12)
        scale = amax / qmax

        def snap(col_block):
            return np.clip(np.round(col_block / scale), -qmax - 1, qmax) * scale
    else:
        cents = np.sort(np.asarray(centroids, np.float64).reshape(-1))
        bounds = (cents[1:] + cents[:-1]) / 2

        def snap(col_block):
            return cents[np.searchsorted(bounds, col_block)]

    Q = np.zeros_like(w)
    for i1 in range(0, d_in, blocksize):
        i2 = min(i1 + blocksize, d_in)
        Wb = w[i1:i2, :].copy()
        Qb = np.zeros_like(Wb)
        Eb = np.zeros_like(Wb)
        Hb = Hinv_chol[i1:i2, i1:i2]
        for i in range(i2 - i1):
            wrow = Wb[i, :]
            d = Hb[i, i]
            qrow = snap(wrow[None, :])[0]
            Qb[i, :] = qrow
            err = (wrow - qrow) / d
            if i + 1 < i2 - i1:
                Wb[i + 1:, :] -= np.outer(Hb[i, i + 1:], err)
            Eb[i, :] = err
        Q[i1:i2, :] = Qb
        if i2 < d_in:
            w[i2:, :] -= Hinv_chol[i1:i2, i2:].T @ Eb

    return Q


def gptq(w: np.ndarray, hessian: np.ndarray, bits: int, **kw) -> GPTQResult:
    """Wrapper returning a GPTQResult with error metrics vs the original weights."""
    w0 = np.asarray(w, np.float64)
    Q = gptq_quantize(w0, hessian, bits, **kw)
    dW = Q - w0
    H = np.asarray(hessian, np.float64)
    err_h = float(np.einsum("io,ij,jo->", dW, H, dW) / dW.shape[1])
    return GPTQResult(Q.astype(np.float32), float(np.linalg.norm(dW)), err_h)


def clustering_vs_quant_mse(w: np.ndarray, bits: int, seed: int = 0) -> Tuple[float, float]:
    """Fig. 2 reproduction: MSE of k-means clustering vs uniform quantization at
    the same equivalent bit-width (2^bits centroids)."""
    from repro_torch.core.clustering import kmeans_1d

    flat = np.asarray(w, np.float32).reshape(-1)
    k = 2 ** bits
    cents = kmeans_1d(flat, k, seed=seed)
    bounds = (cents[1:] + cents[:-1]) / 2
    wc = cents[np.searchsorted(bounds, flat)]
    mse_cluster = float(np.mean((flat - wc) ** 2))
    wq = rtn_weight(flat[None, :], bits, per_channel=False)[0]
    mse_quant = float(np.mean((flat - wq) ** 2))
    return mse_cluster, mse_quant
