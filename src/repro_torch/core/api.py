"""ClusteredTensor parameters — the serving half of the LCD model API.

A `ClusteredTensor` is the framework representation of an LCD-compressed
weight: centroid codes (packed at 2/3/4 bits per code for serving), a tiny
codebook, and the folded smoothing vector. The compression pipeline that
produces them (clustering + distillation) is not part of this module.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.lut import pack_codes, unpack_codes
from repro_torch.utils import resolve_device


class ClusteredTensor(NamedTuple):
    """LCD-compressed linear weight. Logical value = codebook[codes] / smooth[:, None]
    applied as (x / smooth) @ codebook[codes] — see clustered_matmul.

    Serving artifacts are first-class fields, computed once when the tensor is
    assembled:

      packed    — sub-byte packed codes along d_in at `nbits` per code
                  (2 codes/byte at 4-bit, 8 codes in 3 bytes at 3-bit,
                  4 codes/byte at 2-bit); what the serving kernel streams.
      inv_scale — the Eq. 11 fused multiplier 1/(s_m·s_q) per input channel
                  (1/s_m when no activation scale is calibrated).
      act_scale — s_q, the symmetric int8 scale of the smoothed activations;
                  None means "not calibrated": the serving kernel then runs
                  its float variant (smoothing folded, no quantization).

    `nbits` is the tensor's packing width, a plain Python int. Stacked
    per-layer tensors carry a leading layer axis on every array field.
    """
    codes: torch.Tensor                        # (d_in, d_out) int8, or packed uint8
    codebook: torch.Tensor                     # (K,) f32 centroids of the smoothed weight
    smooth: torch.Tensor                       # (d_in,) f32 smoothing vector
    packed: Optional[torch.Tensor] = None      # (packed_rows(d_in, nbits), d_out) uint8
    inv_scale: Optional[torch.Tensor] = None   # (d_in,) f32 = 1/(s_m·s_q)
    act_scale: Optional[torch.Tensor] = None   # () f32 s_q; None = uncalibrated
    nbits: int = 4                             # packing width in {2, 3, 4}

    @property
    def shape(self):
        return self.codes.shape

    @property
    def n_centroids(self) -> int:
        return int(self.codebook.shape[-1])


CT_ARRAY_FIELDS = ("codes", "codebook", "smooth", "packed", "inv_scale",
                   "act_scale")


def is_clustered(x: Any) -> bool:
    return isinstance(x, ClusteredTensor)


def map_arrays(ct: ClusteredTensor, fn) -> ClusteredTensor:
    """Apply `fn` to every array field that is present; `nbits` and the
    `None`s pass through."""
    return ct._replace(**{
        f: fn(getattr(ct, f)) for f in CT_ARRAY_FIELDS
        if getattr(ct, f) is not None})


def _unpack_codes(codes: torch.Tensor, d_in: int, nbits: int = 4) -> torch.Tensor:
    """Unpack sub-byte codes along axis -2 when codes are stored packed
    ((..., packed_rows, d_out) uint8 -> (..., d_in, d_out) int32). Codes
    already at full d_in rows pass through as int32."""
    if codes.shape[-2] == d_in:
        return codes.to(torch.int32)
    return unpack_codes(codes, d_in, nbits)


def clustered_dequant(ct: ClusteredTensor) -> torch.Tensor:
    """Dense equivalent weight W = diag(1/s) @ codebook[codes] (f32)."""
    d_in = ct.smooth.shape[-1]
    w_s = ct.codebook[_unpack_codes(ct.codes, d_in, ct.nbits).long()]
    return w_s / ct.smooth[:, None]


def clustered_matmul(x: torch.Tensor, ct: ClusteredTensor, *,
                     dtype=None) -> torch.Tensor:
    """x @ W via the smoothed factorization: (x / s) @ codebook[codes].
    Codes may be packed (nbits codes per 8 bits along d_in)."""
    dtype = dtype or x.dtype
    d_in = ct.smooth.shape[-1]
    w_s = ct.codebook[_unpack_codes(ct.codes, d_in, ct.nbits).long()].to(dtype)
    xs = x / ct.smooth.to(x.dtype)
    return xs @ w_s


def dense_to_clustered(w: np.ndarray, codes: np.ndarray, codebook: np.ndarray,
                       smooth: Optional[np.ndarray] = None,
                       act_scale: Optional[float] = None,
                       nbits: int = 4, device="cuda") -> ClusteredTensor:
    """Assemble a ClusteredTensor with its serving artifacts precomputed:
    packed sub-byte codes (at `nbits` per code) and the Eq. 11 inv_scale
    (host-side, once, here — never per call on the serving path)."""
    if codebook.shape[-1] > (1 << nbits):
        raise ValueError(
            f"{codebook.shape[-1]} centroids do not fit {nbits}-bit codes "
            f"(max {1 << nbits})")
    d_in = w.shape[0]
    s = np.ones((d_in,), np.float32) if smooth is None else np.asarray(smooth, np.float32)
    sq = 1.0 if act_scale is None else float(act_scale)

    device = resolve_device(device)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ClusteredTensor(
        codes=dev(codes.astype(np.int8)),
        codebook=dev(np.asarray(codebook, np.float32)),
        smooth=dev(s),
        packed=dev(pack_codes(codes.astype(np.uint8), nbits)),
        inv_scale=dev((1.0 / (s * sq)).astype(np.float32)),
        act_scale=None if act_scale is None else dev(np.float32(act_scale)),
        nbits=nbits,
    )
