"""The standalone Eq. 11 input transformation, for Hopper.

    q = clip(round(x * inv_scale), -2^(b-1), 2^(b-1)-1)  as int8,
    inv_scale = 1 / (s_m * s_q) per input channel

— the counterpart of the JAX package's Pallas kernel `smooth_quant`
(src/repro/kernels/smooth_quant.py). On the serving path the transform runs
fused inside the LUT GEMM's K loop; this pass feeds the paper's §4 layer,
whose LUT GEMM (`lut_matmul_int8`) takes int8 activation indices.

On a CUDA tensor the wrapper launches kernels/csrc/smooth_quant.cu on the
current stream and counts the launch; on a CPU tensor it runs the plain
version (kernels/ref.py smooth_quant_ref). The kernel masks ragged shapes
itself: `bm` and `bc`, the Pallas block shape, are accepted for parity with
the reference's signature and do not constrain the shape.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import smooth_quant_ref

# launches since the last reset (plain ints; see kernels/ops.py launch_counts)
LAUNCHES = {"smooth_quant": 0}


def smooth_quant(
    x: torch.Tensor,          # (M, C) float activations
    inv_scale: torch.Tensor,  # (C,) f32 = 1/(s_m * s_q) per channel
    *,
    bits: int = 8,
    bm: int = 256,
    bc: int = 512,
) -> torch.Tensor:
    """(M, C) int8 codes of x under the Eq. 11 multiply, round half to even
    and the clip to [-2^(bits-1), 2^(bits-1)-1]."""
    if x.ndim != 2:
        raise ValueError(f"smooth_quant: x must be 2-D (M, C); got {tuple(x.shape)}")
    m, c = x.shape
    if tuple(inv_scale.shape) != (c,):
        raise ValueError(f"smooth_quant: inv_scale must be ({c},); got "
                         f"{tuple(inv_scale.shape)}")
    if not 1 <= bits <= 8:
        raise ValueError(f"smooth_quant: bits must lie in [1, 8] (int8 codes); got {bits}")
    if inv_scale.device != x.device:
        raise ValueError(f"smooth_quant: inv_scale is on {inv_scale.device}, x on {x.device}")
    if x.device.type != "cuda":
        return smooth_quant_ref(x, inv_scale, bits)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"smooth_quant: x must be float32 or bfloat16; got {x.dtype}")
    if inv_scale.dtype != torch.float32:
        raise TypeError(f"smooth_quant: inv_scale must be float32; got {inv_scale.dtype}")
    for name, t in (("x", x), ("inv_scale", inv_scale)):
        if not t.is_contiguous():
            raise ValueError(f"smooth_quant: {name} must be contiguous; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
    q = torch.empty((m, c), dtype=torch.int8, device=x.device)
    if q.numel() == 0:
        return q
    with torch.cuda.device(x.device):
        err = _build.library().smooth_quant_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), inv_scale.data_ptr(),
            q.data_ptr(), m, c, bits, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "smooth_quant")
    LAUNCHES["smooth_quant"] += 1
    return q
