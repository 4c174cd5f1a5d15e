"""Bucket table-lookup inference (paper §4) and the sub-byte code packing
contract.

Pipeline (Fig. 5): Input Transformation -> Bucket Table Lookup -> Accumulation.

  * activations -> int8 indices q via the fused smooth+quant multiply (Eq. 11);
  * weights are <=4-bit centroid indices into a per-layer codebook c (K <= 16);
  * the product x * w is read from a precomputed table T[q, k] = q * c_k
    (centroid-stationary buckets), storing only non-negative q rows, the
    sign applied during accumulation;
  * the result is rescaled once by the activation scale.

`LUTLayer`, `build_lut_layer`, `lut_forward` and the bucket-table oracle
`lut_matmul_ref` are the port of the JAX package's `repro.core.lut`; the
serving kernels compute the same quantity as a dequantizing contraction.

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

import dataclasses

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


def pack_codes_torch(codes: torch.Tensor, nbits: int = 4) -> torch.Tensor:
    """Device-side pack along axis -2, byte-identical to `pack_codes`:
    (..., d_in, d_out) codes < 2**nbits -> (..., packed_rows(d_in), d_out)
    uint8 on the codes' device."""
    _check_nbits(nbits)
    c = codes.to(torch.int32)
    top = int(c.max()) if c.numel() else 0
    if top >= (1 << nbits) or (c.numel() and int(c.min()) < 0):
        raise ValueError(
            f"codes must fit in {nbits} bits (K <= {1 << nbits}); got max code {top}")
    g = CODES_PER_GROUP[nbits]
    pad = -c.shape[-2] % g
    if pad:
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    lead, d_out = c.shape[:-2], c.shape[-1]
    grp = c.reshape(*lead, -1, g, d_out)
    word = torch.zeros(grp.shape[:-2] + (d_out,), dtype=torch.int32, device=c.device)
    for j in range(g):
        word |= grp[..., j, :] << (nbits * j)
    bpg = BYTES_PER_GROUP[nbits]
    byts = torch.stack([(word >> (8 * b)) & 0xFF for b in range(bpg)], dim=-2)
    return byts.reshape(*lead, -1, d_out).to(torch.uint8)


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


# int4 compatibility wrappers (the seed layout: two codes per byte)

def pack4(codes: np.ndarray) -> np.ndarray:
    """Pack uint4 codes along axis -2: (d_in, d_out) -> (d_in/2, d_out)."""
    return pack_codes(codes, 4)


def unpack4(packed: torch.Tensor, d_in: int) -> torch.Tensor:
    """Inverse of pack4: (d_in/2, d_out) uint8 -> (d_in, d_out) int32."""
    return unpack_codes(packed, d_in, 4)


# ---------------------------------------------------------------------------
# The frozen §4 layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LUTLayer:
    """Frozen inference-time artifact of one clustered+smoothed linear layer
    (host arrays, as in the reference)."""
    codes: np.ndarray        # (d_in, d_out) uint8 centroid indices (< n_centroids)
    codebook: np.ndarray     # (K,) float32 centroids (of the *smoothed* weights)
    smooth: np.ndarray       # (d_in,) smoothing vector s_m
    act_scale: float         # s_q — symmetric int8 scale of smoothed activations
    n_centroids: int

    @property
    def packed_codes(self) -> np.ndarray:
        return pack4(self.codes)

    def table(self, bits: int = 8) -> np.ndarray:
        """Bucket LUT T[q, k] = q * c_k for q in [0, 2^{b-1}-1] (symmetric half)."""
        qs = np.arange(0, 2 ** (bits - 1), dtype=np.float32)   # non-negative levels
        return qs[:, None] * self.codebook[None, :]             # (128, K)


def build_lut_layer(
    w: np.ndarray,
    codes: np.ndarray,
    codebook: np.ndarray,
    smooth: np.ndarray,
    x_calib: np.ndarray,
    bits: int = 8,
) -> LUTLayer:
    """Assemble the frozen serving artifact from distillation outputs.

    `codes`/`codebook` cluster the *smoothed* weights (distillation ran after
    folding, §3.4); x_calib sets the activation scale of the smoothed inputs.
    """
    xs = np.asarray(x_calib, np.float32).reshape(-1, x_calib.shape[-1]) / smooth
    amax = np.abs(xs).max()
    act_scale = float(max(amax, 1e-12) / (2.0 ** (bits - 1) - 1))
    return LUTLayer(
        codes=np.asarray(codes, np.uint8),
        codebook=np.asarray(codebook, np.float32),
        smooth=np.asarray(smooth, np.float32),
        act_scale=act_scale,
        n_centroids=int(codebook.shape[0]),
    )


def lut_matmul_ref(
    q: torch.Tensor,          # (m, d_in) int8 activation indices
    codes: torch.Tensor,      # (d_in, d_out) int centroid indices
    codebook: torch.Tensor,   # (K,) f32
    act_scale,                # scalar or ()
    smooth=None,              # unused at matmul time (folded), kept for API parity
) -> torch.Tensor:
    """Y[m, n] = s_q * sum_j  sign(q[m,j]) * T[|q[m,j]|, codes[j,n]].

    Gather-based bucket lookup, sign applied at accumulation (paper §4.2).

    Symmetric-table contract: the table stores only the 128 non-negative
    levels |q| in [0, 127], so int8's asymmetric extreme q = -128 has no
    bucket row — `mag = min(|q|, 127)` SATURATES it to -127 (an error of one
    LSB, s_q * c_k, on that entry). So this oracle differs from
    `lut_matmul_dequant_ref` (q verbatim) at exactly q = -128 and nowhere
    else. The serving kernels never meet the case: their Eq. 11 transform
    clips symmetrically to [-127, 127]; the standalone `smooth_quant` does
    produce -128.
    """
    k = codebook.shape[0]
    dev = codebook.device
    table = torch.arange(0, 128, dtype=torch.float32, device=dev)[:, None] * codebook[None, :]
    sign = torch.sign(q).to(torch.float32)                 # (m, d_in)
    mag = torch.clamp(q.to(torch.int64).abs(), max=127)    # -128 saturates
    # one-hot over the codes keeps it O(m d_in K) instead of (m, d_in, d_out)
    onehot = torch.nn.functional.one_hot(codes.long(), k).to(torch.float32)  # (d_in, d_out, K)
    bucket = table[mag]                                    # (m, d_in, K)
    signed = bucket * sign[..., None]                      # sign applied in accumulation
    y = torch.einsum("mjk,jnk->mn", signed, onehot)
    return y * act_scale


def lut_forward(layer: LUTLayer, x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """End-to-end §4 pipeline for one layer: transform -> lookup -> accumulate,
    on x's device (the transform is the `smooth_quant` kernel on the card)."""
    from repro_torch.core.smoothing import smooth_quant_input

    dev = x.device
    act = torch.tensor(layer.act_scale, dtype=torch.float32, device=dev)
    q = smooth_quant_input(x, torch.from_numpy(layer.smooth).to(dev), act, bits)
    return lut_matmul_ref(
        q.reshape(-1, q.shape[-1]),
        torch.from_numpy(layer.codes.astype(np.int32)).to(dev),
        torch.from_numpy(layer.codebook).to(dev),
        act,
    ).reshape(*x.shape[:-1], layer.codes.shape[1])


def lut_matmul_dequant_ref(q: torch.Tensor, codes: torch.Tensor,
                           codebook: torch.Tensor,
                           act_scale) -> torch.Tensor:
    """The contraction via explicit dequantization:
    Y = (q * s_q) @ codebook[codes] — the form the serving kernels compute."""
    w = codebook[codes.long()]                             # (d_in, d_out)
    return (q.to(torch.float32) * act_scale) @ w
