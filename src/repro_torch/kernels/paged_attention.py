"""Pool-direct paged attention for Hopper — the counterpart of the JAX
package's Pallas kernel `paged_pool_attention`.

The kernel (kernels/csrc/paged_attention.cu) reads the paged KV pools in
place through the block tables: per decode step the cache traffic is each
slot's true length, not a table-width-padded gathered copy. One kernel serves
float (f32 / bf16) and int8 pools; int8 pools dequantize on chip as
codes · scale[token, head] · smooth[head, :]. On a CUDA tensor the wrapper
launches the kernel on the current stream and counts the launch; on a CPU
tensor it runs the plain version (kernels/ref.py paged_pool_attention_ref).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_pool_attention_ref

# launches of the kernel since the last reset (a plain int; see kernels/ops.py)
LAUNCHES = {"paged_pool_attention": 0}

_POOL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_D = 256


def _check_operands(q, k_pool, v_pool, block_tables, lengths, n_new, k_scale,
                    v_scale, k_smooth, v_smooth):
    name = "paged_pool_attention"
    if q.ndim != 4 or k_pool.ndim != 4:
        raise ValueError(f"{name}: q must be (S,T,H,D) and pools (nb,bs,KV,D); "
                         f"got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    s_slots, _, h, d = q.shape
    nb, bs, kv, dp = k_pool.shape
    if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"{name}: k_pool and v_pool must agree in shape and "
                         f"dtype; got {tuple(k_pool.shape)} {k_pool.dtype} vs "
                         f"{tuple(v_pool.shape)} {v_pool.dtype}")
    if dp != d or h % kv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)} (D equal, KV | H)")
    if d % 32 or d > _MAX_D:
        raise ValueError(f"{name}: head dim must be a multiple of 32 and <= "
                         f"{_MAX_D}; got {d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16; got {q.dtype}")
    if k_pool.dtype not in _POOL_KIND:
        raise TypeError(f"{name}: pools must be float32, bfloat16 or int8; got "
                        f"{k_pool.dtype}")
    if block_tables.ndim != 2 or block_tables.shape[0] != s_slots:
        raise ValueError(f"{name}: block_tables must be (S, NB); got "
                         f"{tuple(block_tables.shape)}")
    ints = (("block_tables", block_tables), ("lengths", lengths),
            ("n_new", n_new))
    for nm, t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {nm} must be int32; got {t.dtype}")
    for nm, t in ints[1:]:
        if tuple(t.shape) != (s_slots,):
            raise ValueError(f"{name}: {nm} must be ({s_slots},); got "
                             f"{tuple(t.shape)}")
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool), *ints]
    if k_pool.dtype == torch.int8:
        for nm, t, shape in (("k_scale", k_scale, (nb, bs, kv)),
                             ("v_scale", v_scale, (nb, bs, kv)),
                             ("k_smooth", k_smooth, (kv, d)),
                             ("v_smooth", v_smooth, (kv, d))):
            if t is None:
                raise ValueError(f"{name}: int8 pools need {nm}")
            if tuple(t.shape) != shape or t.dtype != torch.float32:
                raise ValueError(f"{name}: {nm} must be float32 {shape}; got "
                                 f"{t.dtype} {tuple(t.shape)}")
            tensors.append((nm, t))
    for nm, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


def paged_pool_attention(
    q: torch.Tensor,            # (S, T, H, D) float — post-rope queries
    k_pool: torch.Tensor,       # (nb, bs, KV, D) float or int8 — the paged pool
    v_pool: torch.Tensor,       # (nb, bs, KV, D)
    block_tables: torch.Tensor, # (S, NB) int32 logical->physical
    lengths: torch.Tensor,      # (S,) int32 — cached tokens per slot
    n_new: torch.Tensor,        # (S,) int32 — valid tokens in this window
    window: int,                # sliding window (0 = global), a Python int
    *,
    k_scale: Optional[torch.Tensor] = None,   # (nb, bs, KV) f32 — int8 pools
    v_scale: Optional[torch.Tensor] = None,
    k_smooth: Optional[torch.Tensor] = None,  # (KV, D) f32 — int8 pools
    v_smooth: Optional[torch.Tensor] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Paged attention reading the block pools in place (no gather).

    Query row r of a (slot, kv-head) is (group r // T, token r % T) at
    position lengths[s] + r % T; it sees column c iff c <= position,
    position - c < window (when window > 0) and c < lengths[s] + n_new[s].
    Live blocks are max(ceil((length + n_new) / bs), 1); block ids clamp to
    [0, nb - 1]. A row with nothing visible gives zeros. Returns (S, T, H, D)
    in q's dtype.

    Numerics: online softmax in f32 over a slot's keys — equal to the
    materialized softmax of the plain version up to f32 rounding."""
    _check_operands(q, k_pool, v_pool, block_tables, lengths, n_new, k_scale,
                    v_scale, k_smooth, v_smooth)
    window = int(window)
    if q.device.type != "cuda":
        return paged_pool_attention_ref(
            q, k_pool, v_pool, block_tables, lengths, n_new, window,
            k_scale=k_scale, v_scale=v_scale, k_smooth=k_smooth,
            v_smooth=v_smooth, softcap=softcap)
    s_slots, t, h, d = q.shape
    nb, bs, kv, _ = k_pool.shape
    out = torch.empty_like(q)
    int8 = k_pool.dtype == torch.int8

    def ptr(x):
        return x.data_ptr() if int8 else None

    with torch.cuda.device(q.device):
        err = _build.library().paged_attn_launch(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_pool.data_ptr(),
            v_pool.data_ptr(), _POOL_KIND[k_pool.dtype], ptr(k_scale),
            ptr(v_scale), ptr(k_smooth), ptr(v_smooth),
            block_tables.data_ptr(), lengths.data_ptr(), n_new.data_ptr(),
            out.data_ptr(), s_slots, t, h, kv, d, nb, bs,
            block_tables.shape[1], window, float(softcap),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "paged_pool_attention")
    LAUNCHES["paged_pool_attention"] += 1
    return out
