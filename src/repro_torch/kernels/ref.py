"""Plain PyTorch versions of the CUDA kernels in this package.

They mirror the mathematical definition, not the machine mapping. The CPU
tests run them, a kernel's wrapper uses them for CPU tensors, and the on-card
smoke script holds every kernel against them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.lut import lut_matmul_dequant_ref, unpack_codes

KC = 16
# the fewest rows the plain LUT GEMM computes at once (`lut_matmul_fused_ref`)
MIN_ROWS = 16


def lut_matmul_f32_ref(x: torch.Tensor, packed_codes: torch.Tensor,
                       codebook: torch.Tensor, *, nbits: int = 4) -> torch.Tensor:
    """Y = x @ codebook[codes], codes stored packed at `nbits` per code."""
    k = x.shape[-1]
    codes = unpack_codes(packed_codes, k, nbits)        # (K, N) int32
    w = codebook[codes.long()]                          # (K, N) f32
    return x.to(torch.float32) @ w


def lut_matmul_int8_ref(q: torch.Tensor, packed_codes: torch.Tensor,
                        codebook: torch.Tensor, act_scale, *,
                        nbits: int = 4) -> torch.Tensor:
    """Paper §4.2 semantics: signed bucket-table accumulation, then one
    rescale — act_scale * (q @ codebook[codes])."""
    k = q.shape[-1]
    codes = unpack_codes(packed_codes, k, nbits)
    w = codebook[codes.long()]
    return (q.to(torch.float32) @ w) * act_scale


def lut_matmul_fused_ref(
    x: torch.Tensor,            # (M, K) raw activations
    inv_scale: torch.Tensor,    # (K,) = 1/(s_m·s_q)  (or 1/s_m when quantize=False)
    packed_codes: torch.Tensor,
    codebook: torch.Tensor,
    act_scale,                  # scalar s_q (ignored when quantize=False)
    *,
    quantize: bool = True,
    nbits: int = 4,
) -> torch.Tensor:
    """The fused serving GEMM: Eq. 11 transform (symmetric clip, |q| <= 127)
    composed with the gather-dequant contraction. `torch.round` rounds half
    to even, as the kernels' `rintf` does.

    On the CPU fewer than MIN_ROWS rows of x are computed inside MIN_ROWS
    (zero rows added, sliced away after): the CPU's GEMM sums a row in
    another order at 2 or 4 rows than at 16 and more, and a row's bits must
    not depend on how many rows share the call (the kernels' row contract),
    nor a column's on how many columns do (a mesh's column shard). The card
    computes the rows it is given."""
    k = x.shape[-1]
    m = x.shape[0]
    if x.device.type == "cpu" and 0 < m < MIN_ROWS:
        x = torch.cat([x, x.new_zeros((MIN_ROWS - m,) + tuple(x.shape[1:]))])
    codes = unpack_codes(packed_codes, k, nbits)
    xs = x.to(torch.float32) * inv_scale
    if not quantize:
        return (xs @ codebook[codes.long()])[:m]
    q = torch.clamp(torch.round(xs), -127, 127).to(torch.int8)
    return lut_matmul_dequant_ref(q, codes, codebook, act_scale)[:m]


def lut_matmul_fused_multi_ref(
    x: torch.Tensor,            # (M, K) raw activations shared by all projections
    inv_list,                   # P × (K,) f32
    packed_list,                # P × (K*nbits_p//8, N_p) uint8
    cb_list,                    # P × (K_active,) f32
    act_list,                   # P × scalar s_q
    *,
    quantize,                   # P × bool
    nbits,                      # P × int
):
    """The fused multi-projection GEMM: each projection is the single-
    projection plain version on the shared input — fusion is a scheduling
    transform, so the definition does not change, and a projection's result
    is the same bits as its `lut_matmul_fused_ref` call. Returns a list of P
    (M, N_p) outputs."""
    return [
        lut_matmul_fused_ref(x, inv_list[p], packed_list[p], cb_list[p],
                             act_list[p], quantize=quantize[p], nbits=nbits[p])
        for p in range(len(packed_list))
    ]


def lut_matmul_t_ref(dy: torch.Tensor, packed_codes: torch.Tensor,
                     codebook: torch.Tensor, *, nbits: int = 4) -> torch.Tensor:
    """dXs = dY @ codebook[codes]^T: the input gradient of Y = Xs @
    codebook[codes], over the packed rows' K (M, K f32)."""
    k = packed_codes.shape[0] * 8 // nbits
    w = codebook[unpack_codes(packed_codes, k, nbits).long()]        # (K, N)
    return dy.to(torch.float32) @ w.T


def lut_codebook_grad_ref(xs: torch.Tensor, dy: torch.Tensor, packed_codes: torch.Tensor,
                          codebook: torch.Tensor, smooth: torch.Tensor, *,
                          nbits: int = 4):
    """The codebook's and the smoothing vector's gradients of Y = (x /
    smooth) @ codebook[codes], given Xs = x / smooth and dY: with G = Xsᵀ dY,
    dcodebook[c] = the sum of G over the (k, n) whose code is c, and
    dsmooth[k] = -(1 / smooth[k]) * sum_n G[k, n] W[k, n]. Returns
    (dcodebook like `codebook`, dsmooth (K,))."""
    k = xs.shape[-1]
    codes = unpack_codes(packed_codes, k, nbits).long()
    g = xs.to(torch.float32).T @ dy.to(torch.float32)                # (K, N)
    dcb = torch.zeros_like(codebook, dtype=torch.float32).index_add_(
        0, codes.reshape(-1), g.reshape(-1))
    dsmooth = -(g * codebook[codes]).sum(dim=1) / smooth
    return dcb, dsmooth


def smooth_quant_ref(x: torch.Tensor, inv_scale: torch.Tensor,
                     bits: int = 8) -> torch.Tensor:
    """int8(clip(round(x * inv_scale), -2^(b-1), 2^(b-1)-1)): the standalone
    Eq. 11 transform. Unlike the fused kernels' symmetric ±127 clip it keeps
    -128 (at 8 bits), as the reference's kernel does. `torch.round` rounds
    half to even, as the kernel's `rintf` does."""
    qmin = -(2.0 ** (bits - 1))
    qmax = 2.0 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x.to(torch.float32) * inv_scale), qmin, qmax)
    return q.to(torch.int8)


def _masked_paged_softmax(q, k, v, lengths, n_new, window: int, softcap: float):
    """Masked softmax attention over per-slot ragged logical KV views:
    q (S,T,H,D) float; k/v (S,L,KV,D) float. `window` is a Python int.

    One batched call over every slot and kv-head (`_batched_softmax`). On
    the CPU the g·T query rows of each (slot, kv-head) are first padded with
    zero queries to at least MIN_ROWS (sliced away after): the CPU's batched
    GEMM and vectorised exp give a row other bits at fewer rows, and a row's
    bits must not depend on how many window positions share the call (a
    verify's window, a mesh's kv-head shards). The card computes the rows it
    is given."""
    if q.device.type != "cpu":
        return _batched_softmax(q, k, v, lengths, n_new, window, softcap)
    t, g = q.shape[1], q.shape[2] // k.shape[2]
    if g * t < MIN_ROWS:
        q = torch.cat([q, q.new_zeros((q.shape[0], -(-MIN_ROWS // g) - t) + tuple(q.shape[2:]))],
                      dim=1)
    out = _batched_softmax(q, k, v, lengths, n_new, window, softcap)
    return out[:, :t].contiguous()


def _batched_softmax(q, k, v, lengths, n_new, window: int, softcap: float):
    """`_masked_paged_softmax` as one batched call over every slot and
    kv-head, on the rows it is given."""
    s_slots, t, h, d = q.shape
    l, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.to(torch.float32).reshape(s_slots, t, kv, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qf,
                          k.to(torch.float32)) / math.sqrt(d)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    dev = q.device
    q_pos = lengths[:, None] + torch.arange(t, device=dev)[None, :]    # (S, T)
    k_pos = torch.arange(l, device=dev)
    weff = window if window > 0 else 1 << 30
    mask = q_pos[:, :, None] >= k_pos[None, None, :]
    mask &= (q_pos[:, :, None] - k_pos[None, None, :]) < weff
    mask &= k_pos[None, None, :] < (lengths + n_new)[:, None, None]
    mexp = mask[:, None, None]                                         # (S,1,1,T,L)
    scores = torch.where(mexp, scores, torch.full_like(scores, -1e30))
    m = torch.clamp(scores.max(dim=-1, keepdim=True).values, min=-1e30)
    p = torch.exp(scores - m) * mexp.to(torch.float32)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.to(torch.float32))
    return out.reshape(s_slots, t, h, d).to(q.dtype)


def paged_pool_attention_ref(q, k_pool, v_pool, block_tables, lengths, n_new,
                             window: int, *, k_scale=None, v_scale=None,
                             k_smooth=None, v_smooth=None, softcap: float = 0.0):
    """Pool-direct paged attention, the plain way: gather the slot-visible
    logical view through the block tables (the materialization the kernel
    avoids), dequantize int8 pools, masked softmax.

    q (S,T,H,D); k_pool/v_pool (nb,bs,KV,D) float or int8 (int8 needs
    k_scale/v_scale (nb,bs,KV) and k_smooth/v_smooth (KV,D));
    block_tables (S,NB) int32; lengths/n_new (S,); window a Python int."""
    s_slots = q.shape[0]
    nb = k_pool.shape[0]
    bt = torch.clamp(block_tables, 0, nb - 1).long()
    kg = k_pool[bt].reshape(s_slots, -1, *k_pool.shape[2:])   # (S, L, KV, D)
    vg = v_pool[bt].reshape(s_slots, -1, *v_pool.shape[2:])
    if k_pool.dtype == torch.int8:
        ksg = k_scale[bt].reshape(s_slots, -1, k_pool.shape[2])
        vsg = v_scale[bt].reshape(s_slots, -1, v_pool.shape[2])
        k = (kg.to(torch.float32) * ksg[..., None]
             * k_smooth[None, None].to(torch.float32))
        v = (vg.to(torch.float32) * vsg[..., None]
             * v_smooth[None, None].to(torch.float32))
    else:
        k, v = kg, vg
    return _masked_paged_softmax(q, k, v, lengths, n_new, int(window), softcap)


def paged_dequant_attention_ref(q, kq, k_scale, vq, v_scale, k_smooth, v_smooth,
                                lengths, n_new, window, *, softcap: float = 0.0):
    """Dequantizing paged attention over an already-gathered int8 view, the
    plain way: k = codes · scale[token, head] · smooth[head, :] materialized,
    then the masked softmax. q (S,T,H,D); kq/vq (S,L,KV,D) int8; scales
    (S,L,KV) f32; smooth (KV,D) f32; lengths/n_new (S,) int32; window a
    Python int or a 0-d tensor (read back to the host here)."""
    k = (kq.to(torch.float32) * k_scale[..., None]
         * k_smooth[None, None].to(torch.float32))             # (S, L, KV, D)
    v = (vq.to(torch.float32) * v_scale[..., None]
         * v_smooth[None, None].to(torch.float32))
    return _masked_paged_softmax(q, k, v, lengths, n_new, int(window), softcap)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0, k_len: int = 0):
    """Plain materialized softmax attention over (BH, S, D): query row i sits
    at position q_offset + i and sees key j iff j <= it (causal), it - j <
    window (window > 0) and j < k_len (k_len > 0). Masked scores are -1e30, so
    a row that sees no key averages every value, as the online kernel's does.
    Returns q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = q_offset + torch.arange(q.shape[1], device=q.device)
    kp = torch.arange(k.shape[1], device=q.device)
    m = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        m &= qp[:, None] >= kp[None, :]
    if window:
        m &= (qp[:, None] - kp[None, :]) < window
    if k_len > 0:
        m &= kp[None, :] < k_len
    s = torch.where(m[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)
