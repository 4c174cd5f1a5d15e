"""Sub-byte code packing and the reference LUT contraction (paper §4).

Width contract, shared by the host packer, the tensor unpacker and the CUDA
kernels' decode (kernels/csrc/lut_common.cuh):

  nbits=4 : 2 codes/byte           byte  = c0 | c1<<4           (1 byte/group)
  nbits=3 : 8 codes in 3 bytes     word24 = sum c_j << 3j, stored little-endian
                                   as rows [3g, 3g+1, 3g+2]     (3 bytes/group)
  nbits=2 : 4 codes/byte           byte  = c0|c1<<2|c2<<4|c3<<6 (1 byte/group)

Codes pack along axis -2 (d_in, the contraction axis); d_in pads up to a whole
group with zero codes (padded rows are never referenced: the activation and
inv_scale padding is zero there). Packed rows per d_in therefore satisfy
rows * 8 == padded_d_in * nbits. The layout is byte-identical to the JAX
package's `repro.core.lut`.
"""
from __future__ import annotations

import numpy as np
import torch

SUPPORTED_NBITS = (2, 3, 4)
CODES_PER_GROUP = {2: 4, 3: 8, 4: 2}
BYTES_PER_GROUP = {2: 1, 3: 3, 4: 1}


def _check_nbits(nbits: int) -> None:
    if nbits not in SUPPORTED_NBITS:
        raise ValueError(f"nbits must be one of {SUPPORTED_NBITS}; got {nbits}")


def padded_d_in(d_in: int, nbits: int) -> int:
    """d_in rounded up to a whole packing group."""
    _check_nbits(nbits)
    g = CODES_PER_GROUP[nbits]
    return -(-d_in // g) * g


def packed_rows(d_in: int, nbits: int) -> int:
    """Rows of the packed byte tensor covering `d_in` input channels."""
    return padded_d_in(d_in, nbits) * nbits // 8


def pack_codes(codes: np.ndarray, nbits: int = 4) -> np.ndarray:
    """Host-side pack along axis -2: (..., d_in, d_out) uint codes ->
    (..., packed_rows(d_in), d_out) uint8. Codes must be < 2**nbits."""
    _check_nbits(nbits)
    c = np.asarray(codes, np.uint8)
    if int(c.max(initial=0)) >= (1 << nbits):
        raise ValueError(
            f"codes must fit in {nbits} bits (K <= {1 << nbits}); "
            f"got max code {int(c.max(initial=0))}")
    g = CODES_PER_GROUP[nbits]
    pad = -c.shape[-2] % g
    if pad:
        widths = [(0, 0)] * c.ndim
        widths[-2] = (0, pad)
        c = np.pad(c, widths)
    lead, d_out = c.shape[:-2], c.shape[-1]
    grp = c.reshape(*lead, -1, g, d_out).astype(np.uint32)
    word = np.zeros(grp.shape[:-2] + (d_out,), np.uint32)
    for j in range(g):
        word |= grp[..., j, :] << (nbits * j)
    bpg = BYTES_PER_GROUP[nbits]
    byts = np.stack([(word >> (8 * b)) & 0xFF for b in range(bpg)], axis=-2)
    return byts.reshape(*lead, -1, d_out).astype(np.uint8)


def unpack_codes(packed: torch.Tensor, d_in: int, nbits: int = 4) -> torch.Tensor:
    """Inverse of pack_codes along axis -2: (..., packed_rows, d_out) uint8 ->
    (..., d_in, d_out) int32 (group padding sliced off)."""
    _check_nbits(nbits)
    rows = packed.shape[-2]
    if rows != packed_rows(d_in, nbits):
        raise ValueError(
            f"packed tensor has {rows} rows but d_in={d_in} at {nbits}-bit "
            f"packing needs {packed_rows(d_in, nbits)} "
            f"(= padded_d_in * nbits / 8); shape {tuple(packed.shape)}")
    g = CODES_PER_GROUP[nbits]
    bpg = BYTES_PER_GROUP[nbits]
    lead, d_out = packed.shape[:-2], packed.shape[-1]
    grp = packed.reshape(*lead, -1, bpg, d_out).to(torch.int32)
    word = grp[..., 0, :]
    for b in range(1, bpg):
        word = word | (grp[..., b, :] << (8 * b))
    mask = (1 << nbits) - 1
    full = torch.stack([(word >> (nbits * j)) & mask for j in range(g)],
                       dim=-2).reshape(*lead, -1, d_out)
    return full[..., :d_in, :]


def lut_matmul_dequant_ref(q: torch.Tensor, codes: torch.Tensor,
                           codebook: torch.Tensor,
                           act_scale) -> torch.Tensor:
    """The contraction via explicit dequantization:
    Y = (q * s_q) @ codebook[codes] — the form the serving kernels compute."""
    w = codebook[codes.long()]                             # (d_in, d_out)
    return (q.to(torch.float32) * act_scale) @ w
