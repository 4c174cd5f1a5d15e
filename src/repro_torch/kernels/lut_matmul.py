"""Fused sub-byte-code dequant + matmul — the LCD serving GEMM, for Hopper.

Two entry points, the counterparts of the JAX package's Pallas kernels of the
same names:

  lut_matmul_fused      — Y = T(x) @ codebook[codes], any M (used for M >= 128);
  lut_matmul_fused_gemv — the same contraction for decode, M < 128.

T is the Eq. 11 input transform: x · inv_scale, and when `quantize`
clip(round(·), ±127) with round-half-to-even. The caller applies the trailing
s_q rescale. Weights arrive as packed centroid codes at `nbits` in {2, 3, 4}
per code (core/lut.py layout); the codebook is padded to KC entries.

On a CUDA tensor a wrapper launches its kernel (kernels/csrc/lut_gemv.cu,
lut_gemm.cu) on the current stream and counts the launch; on a CPU tensor it
runs the plain version (kernels/ref.py). The kernels take the true M and N and
mask ragged edges themselves; K must be the packing-group-padded d_in. Both
sum over K in one fixed order, so a row's result is the same bits from either.
"""
from __future__ import annotations

import torch

from repro_torch.core.lut import SUPPORTED_NBITS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import lut_matmul_fused_ref

# Codebook capacity the kernels are specialized for: <= 4-bit codes. Codebooks
# are always padded to KC entries; an nbits-wide tensor references the first
# 2^nbits of them.
KC = 16

# launches of each kernel since the last reset (plain ints; see kernels/ops.py)
LAUNCHES = {"lut_matmul_fused_gemv": 0, "lut_matmul_fused": 0}


def _check_packed_shape(k: int, packed_shape, nbits: int, caller: str) -> None:
    """Explicit shape validation for the packed-code operand, naming the
    packing width and the offending shapes, so a 2-bit tensor routed through a
    4-bit call site fails loudly instead of streaming garbage codes."""
    if nbits not in SUPPORTED_NBITS:
        raise ValueError(
            f"{caller}: nbits must be one of {SUPPORTED_NBITS}; got {nbits}")
    k2 = packed_shape[0]
    if k2 * 8 != k * nbits:
        raise ValueError(
            f"{caller}: packed codes have {k2} rows but K={k} at "
            f"{nbits}-bit packing needs K*nbits/8 = {k * nbits / 8:g} "
            f"(packed shape {tuple(packed_shape)}); did the activation and "
            f"the packed tensor disagree on the packing width?")


def _check_operands(x, inv_scale, packed_codes, codebook, nbits, caller):
    if x.ndim != 2 or packed_codes.ndim != 2:
        raise ValueError(f"{caller}: x and packed_codes must be 2-D; got "
                         f"{tuple(x.shape)} and {tuple(packed_codes.shape)}")
    m, k = x.shape
    _check_packed_shape(k, packed_codes.shape, nbits, caller)
    if tuple(inv_scale.shape) != (k,):
        raise ValueError(f"inv_scale must be ({k},); got {tuple(inv_scale.shape)}")
    if tuple(codebook.shape) != (KC,):
        raise ValueError(f"codebook must be padded to ({KC},); got "
                         f"{tuple(codebook.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{caller}: x must be float32 or bfloat16; got {x.dtype}")
    if packed_codes.dtype != torch.uint8:
        raise TypeError(f"{caller}: packed_codes must be uint8; got "
                        f"{packed_codes.dtype}")
    for name, t in (("inv_scale", inv_scale), ("codebook", codebook)):
        if t.dtype != torch.float32:
            raise TypeError(f"{caller}: {name} must be float32; got {t.dtype}")
    for name, t in (("x", x), ("inv_scale", inv_scale),
                    ("packed_codes", packed_codes), ("codebook", codebook)):
        if t.device != x.device:
            raise ValueError(f"{caller}: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be contiguous; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


def _launch(name: str, c_name: str, x, inv_scale, packed_codes, codebook,
            quantize, nbits):
    m, k = x.shape
    n = packed_codes.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = getattr(_build.library(), c_name)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 inv_scale.data_ptr(), packed_codes.data_ptr(),
                 codebook.data_ptr(), y.data_ptr(), m, k, n,
                 packed_codes.shape[0], nbits, int(bool(quantize)),
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)
    LAUNCHES[name] += 1
    return y


def lut_matmul_fused(
    x: torch.Tensor,            # (M, K) float — RAW activations (not smoothed)
    inv_scale: torch.Tensor,    # (K,) f32 = 1/(s_m·s_q) (quantize) or 1/s_m
    packed_codes: torch.Tensor, # (K*nbits//8, N) uint8 — packed centroid codes
    codebook: torch.Tensor,     # (KC,) f32 — padded with zeros beyond the active K
    *,
    quantize: bool = True,
    nbits: int = 4,
) -> torch.Tensor:
    """Y = transform(x) @ codebook[codes] in f32, the transform fused into the
    K loop; no intermediate activation tensor in device memory."""
    _check_operands(x, inv_scale, packed_codes, codebook, nbits,
                    "lut_matmul_fused")
    if x.device.type != "cuda":
        return lut_matmul_fused_ref(x, inv_scale, packed_codes, codebook, 1.0,
                                    quantize=quantize, nbits=nbits)
    return _launch("lut_matmul_fused", "lut_gemm_launch", x, inv_scale,
                   packed_codes, codebook, quantize, nbits)


def lut_matmul_fused_gemv(
    x: torch.Tensor,            # (M, K), M < 128 (decode micro-batch)
    inv_scale: torch.Tensor,    # (K,) f32
    packed_codes: torch.Tensor, # (K*nbits//8, N) uint8
    codebook: torch.Tensor,     # (KC,) f32
    *,
    quantize: bool = True,
    nbits: int = 4,
) -> torch.Tensor:
    """Decode-specialized fused GEMV: the packed codes are the only operand
    of size, read once; K is split inside each thread block so that a few
    rows of M still fill the card."""
    if x.ndim == 2 and x.shape[0] >= 128:
        raise ValueError(
            f"lut_matmul_fused_gemv: M ({x.shape[0]}) must be < 128")
    _check_operands(x, inv_scale, packed_codes, codebook, nbits,
                    "lut_matmul_fused_gemv")
    if x.device.type != "cuda":
        return lut_matmul_fused_ref(x, inv_scale, packed_codes, codebook, 1.0,
                                    quantize=quantize, nbits=nbits)
    return _launch("lut_matmul_fused_gemv", "lut_gemv_launch", x, inv_scale,
                   packed_codes, codebook, quantize, nbits)
