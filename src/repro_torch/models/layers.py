"""Layer library of the dense transformer family: the paged attention block
of the continuous-batching engine, and the contiguous-cache attention block
of the static-batch path and of the full-sequence forward (train, prefill,
evaluation).

Everything is functional: `fn(params_subtree, inputs, cfg, ...) -> outputs`,
on plain tensors and nested dicts of tensors. Names and conventions are those
of the JAX package's `models/layers.py`; its sharding annotations
(`maybe_shard`) have no counterpart here, the port serves on one device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.api import _unpack_codes, is_clustered
from repro_torch.kernels.ops import clustered_linear, clustered_linear_multi
from repro_torch.kernels.paged_attention import paged_pool_attention
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# Linear / norms
# ---------------------------------------------------------------------------

def resolve_weight(w, dtype) -> torch.Tensor:
    """Dense view of a (possibly clustered) weight: codebook[codes] / smooth."""
    if not is_clustered(w):
        return w.to(dtype)
    d_in = w.smooth.shape[-1]
    codes = _unpack_codes(w.codes, d_in, w.nbits).long()   # (..., d_in, d_out)
    if w.codebook.ndim == 1:
        dense = w.codebook[codes]
    else:                                                  # stacked (E, K)
        dense = torch.stack([cb[cd] for cb, cd in zip(w.codebook, codes)])
    return (dense / w.smooth[..., :, None]).to(dtype)


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense projection. `w` may be a plain tensor or an LCD ClusteredTensor;
    clustered weights go through kernels.ops.clustered_linear (the fused
    smooth+quant+LUT kernels on CUDA tensors)."""
    if is_clustered(w):
        y = clustered_linear(x, w)
    else:
        y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def linear_group(x: torch.Tensor, ws, bs, cfg: ModelConfig) -> Tuple[torch.Tensor, ...]:
    """Projections sharing one input (QKV; gate+up), fused when possible.

    With `cfg.fused_projections` on and every weight clustered, the group goes
    through kernels.ops.clustered_linear_multi: ONE multi-projection LUT
    launch whose outputs are the same bits as per-projection calls, so the
    flag changes launch counts, never numerics. Otherwise — or with any dense
    weight in the group — each projection is an independent `linear` call."""
    if (cfg.fused_projections and len(ws) > 1
            and all(is_clustered(w) for w in ws)):
        ys = clustered_linear_multi(x, ws)
    else:
        ys = tuple(linear(x, w) for w in ws)
    return tuple(y if b is None else y + b.to(y.dtype)
                 for y, b in zip(ys, bs))


# PyTorch's CUDA reduction picks its thread-block shape from the number of rows
# it reduces until there are 16 of them (torch 2.11 on an H100: 64 x 8 threads
# a block at 8 rows, 32 x 16 from 16 rows on), and each shape sums a row in
# another order: a row's f32 mean has other bits at 8 rows than at 32 or 256.
# A token is normed at S rows in a decode step but at S * T in a mixed step or
# a speculative verify, and the same token must get the same bits in each, so
# every statistic of a norm is taken over at least 16 rows.
_MIN_STAT_ROWS = 16


def _stat_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(f32 rows of x, repeated to at least _MIN_STAT_ROWS, as (reps, r, d);
    r). Fewer than 16 rows are reduced as copies (they come out of the f32
    conversion, no extra kernel), so a row's bits do not depend on how many
    rows are normed together."""
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    r = rows.shape[0]
    reps = -(-_MIN_STAT_ROWS // r) if 0 < r < _MIN_STAT_ROWS else 1
    return rows.expand(reps, r, d).to(torch.float32), r


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in f32, back in x's dtype;
    the statistic over at least 16 rows (`_stat_rows`)."""
    xf, r = _stat_rows(x)
    ms = (xf * xf).reshape(-1, x.shape[-1]).mean(dim=-1)[:r, None]
    nrm = xf[0] * torch.rsqrt(ms + eps)
    return (nrm * (1.0 + scale.to(torch.float32))).to(x.dtype).view(x.shape)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias, in f32, back in x's
    dtype. Both statistics are reductions over a row, so both are taken
    over at least 16 rows (`_stat_rows`): the mean of every repeated row,
    then the variance of the rows centred by it."""
    d = x.shape[-1]
    xf, r = _stat_rows(x)
    mu = xf.reshape(-1, d).mean(dim=-1).view(xf.shape[0], r, 1)
    xc = xf - mu
    var = (xc * xc).reshape(-1, d).mean(dim=-1)[:r, None]
    out = xc[0] * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype).view(x.shape)


def norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); pos: broadcastable to (..., S). Rotates pairs
    (d, d+D/2). Angles, cos and sin are f32; the rotation itself runs in the
    activation dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.to(torch.float32)[..., None] * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    c2, s2 = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * c2 - x2 * s2, x2 * c2 + x1 * s2], dim=-1)


# ---------------------------------------------------------------------------
# Attention over a contiguous cache (q-chunked, GQA, window, softcap)
# ---------------------------------------------------------------------------

def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(scores / cap) if cap > 0 else scores


def _attn_chunk(q, k, v, q_pos, k_pos, *, causal, window: int, softcap: float,
                scale: float) -> torch.Tensor:
    """q: (B, Cq, H, D); k/v: (B, Sk, KV, D) with KV | H. Returns (B, Cq, H, D).

    As in the JAX package, scores are taken in f32 and then held in bf16 on a
    bf16 model (the row sum stays f32); the probabilities meet V in that dtype
    with an f32 result. `window` is a Python int (0 = global);
    `q_pos` (Cq,) and `k_pos` (Sk,) are positions on q's device."""
    b, cq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    cdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    qf = q.to(torch.float32).reshape(b, cq, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32)) * scale
    scores = _softcap(scores, softcap).to(cdt)
    qp, kp = q_pos[:, None], k_pos[None, :]
    mask = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    scores = torch.where(mask, scores, torch.full((), -torch.inf, dtype=cdt,
                                                  device=q.device))
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=-1e30)  # fully masked rows
    e = torch.exp(scores - m)
    ssum = e.to(torch.float32).sum(dim=-1, keepdim=True)
    probs = e / torch.clamp(ssum, min=1e-30).to(cdt)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(torch.float32),
                       v.to(cdt).to(torch.float32))
    return out.reshape(b, cq, h, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, D) at positions q_offset.., k/v (B, Sk, KV, D) at 0..Sk-1.
    Queries go in chunks of at most `chunk` rows (the largest divisor of Sq
    not above it), so the score tensor never holds Sq x Sk at once; the JAX
    package scans the same chunks."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    k_pos = torch.arange(sk, device=q.device)
    if sq > chunk and sq % chunk:
        chunk = next(c for c in range(chunk, 0, -1) if sq % c == 0)
    # with more than one chunk under autograd, each chunk's body is
    # recomputed in the backward instead of keeping its S x chunk scores and
    # probabilities (the JAX package checkpoints its chunk scan the same way):
    # the numbers are the same, only the memory differs
    remat = sq > chunk and torch.is_grad_enabled()
    outs = []
    for c0 in range(0, sq, min(sq, chunk)):
        c1 = min(sq, c0 + chunk)
        q_pos = q_offset + torch.arange(c0, c1, device=q.device)
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        if remat:
            outs.append(checkpoint(_attn_chunk, q[:, c0:c1], k, v, q_pos, k_pos,
                                   use_reentrant=False, **kw))
        else:
            outs.append(_attn_chunk(q[:, c0:c1], k, v, q_pos, k_pos, **kw))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _absmax_int8(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, kv-head) absmax int8 of the static cache: (B, S, KV, D) ->
    codes int8 and scales f32 (B, S, KV)."""
    tf = t.to(torch.float32)
    scale = torch.clamp(tf.abs().amax(dim=3, keepdim=True), min=1e-6) / 127.0
    codes = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return codes, scale[..., 0]


def attn_block(
    p: Dict[str, Any],
    x: torch.Tensor,              # (B, S, d_model)
    cfg: ModelConfig,
    *,
    layer_window: int = 0,        # 0 = global
    cache: Optional[Dict[str, Any]] = None,   # one layer's {"k","v","pos"[,scales]}
    pos_offset: int = 0,
) -> torch.Tensor:
    """Attention block over a contiguous cache. With `cache` (the static
    decode path) this step's K/V are written at `cache["pos"]` — a 0-d int32
    tensor on the cache's device, as in the JAX package, or a host int — by
    index, and the queries attend over the whole cache, later positions
    masked by causality. Nothing here reads `pos` back to the host, so the
    step can be captured once and replayed at every position. UNLIKE the
    JAX package, which returns a new cache, the cache tensors (one layer's
    views of the stacked cache) are UPDATED IN PLACE; the caller advances
    `pos`. An int8 cache stores absmax codes with per-(token, kv-head)
    scales and is dequantized in the activation dtype on read."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads_eff, cfg.n_kv_heads
    base = cache["pos"] if cache is not None else pos_offset
    q, k, v = linear_group(
        x, (p["wq"], p["wk"], p["wv"]),
        (p.get("bq"), p.get("bk"), p.get("bv")), cfg)
    pos = base + torch.arange(s, device=x.device)
    q = rope(q.reshape(b, s, nh, hd), pos, cfg.rope_theta)
    k = rope(k.reshape(b, s, nkv, hd), pos, cfg.rope_theta)
    v = v.reshape(b, s, nkv, hd)

    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        if kc.dtype == torch.int8:
            kq, ks_new = _absmax_int8(k)
            vq, vs_new = _absmax_int8(v)
            kc.index_copy_(1, pos, kq)
            vc.index_copy_(1, pos, vq)
            cache["k_scale"].index_copy_(1, pos, ks_new)
            cache["v_scale"].index_copy_(1, pos, vs_new)
            k = kc.to(x.dtype) * cache["k_scale"][..., None].to(x.dtype)
            v = vc.to(x.dtype) * cache["v_scale"][..., None].to(x.dtype)
        else:
            kc.index_copy_(1, pos, k.to(kc.dtype))
            vc.index_copy_(1, pos, v.to(vc.dtype))
            k, v = kc, vc

    o = attention(q, k, v, causal=True, window=int(layer_window),
                  softcap=cfg.attn_softcap, q_offset=base)
    return linear(o.reshape(b, s, nh * hd), p["wo"])


# ---------------------------------------------------------------------------
# Paged attention block (continuous-batching serving engine)
# ---------------------------------------------------------------------------

def quantize_kv(t: torch.Tensor, smooth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smoothed symmetric int8 quantization of one step's K or V: divide
    channel outliers away with the calibrated per-(kv-head, channel) smoothing
    vector, then absmax-quantize per (token, kv-head).

    t: (..., KV, D); smooth: (KV, D). Returns (codes int8 (..., KV, D),
    scale f32 (..., KV)); dequant is `codes * scale * smooth`."""
    ts = t.to(torch.float32) / smooth.to(torch.float32)
    amax = torch.amax(torch.abs(ts), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    codes = torch.clamp(torch.round(ts / scale), -127, 127).to(torch.int8)
    return codes, scale[..., 0]


def _scatter_rows(pool: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  valid: torch.Tensor) -> None:
    """pool.view(nb*bs, ...)[idx[i]] = vals[i] for the valid i only, in place.

    `index_put_` has no drop mode and a boolean-mask index would wait for the
    host, so a padded token is redirected — index AND value — to the first
    valid token of the step: it rewrites what that token writes anyway. With
    no valid token at all every write targets one row and carries that row's
    current content. Duplicate indices therefore always carry equal values,
    which makes the result deterministic; nothing observable is written for a
    padded token and nothing synchronises with the host."""
    flat = pool.view(-1, *pool.shape[2:])
    # index_select, not `t[anchor]`: indexing with a 0-d tensor reads it back
    anchor = torch.argmax(valid.to(torch.int8)).view(1)    # first valid, else 0
    any_valid = valid.index_select(0, anchor)
    idx = torch.where(valid, idx, idx.index_select(0, anchor))
    shape = (-1,) + (1,) * (vals.ndim - 1)
    vals = torch.where(valid.view(shape), vals, vals.index_select(0, anchor))
    vals = torch.where(any_valid.view(shape), vals, flat.index_select(0, idx))
    flat.index_put_((idx,), vals)


def paged_attn_block(
    p: Dict[str, Any],
    x: torch.Tensor,              # (S_slots, T, d_model) — T new tokens/slot
    cfg: ModelConfig,
    *,
    layer_window: int,
    kc: torch.Tensor,             # (num_blocks, block_size, KV, D) paged K
    vc: torch.Tensor,             # (num_blocks, block_size, KV, D) paged V
    block_tables: torch.Tensor,   # (S_slots, max_blocks) int32 logical->physical
    lengths: torch.Tensor,        # (S_slots,) int32 tokens already in the cache
    n_new: torch.Tensor,          # (S_slots,) int32 valid tokens among the T fed
    kc_scale: Optional[torch.Tensor] = None,   # (num_blocks, block_size, KV) f32
    vc_scale: Optional[torch.Tensor] = None,   # int8 cache only
    k_smooth: Optional[torch.Tensor] = None,   # (KV, D) f32 smoothing vectors
    v_smooth: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One attention block over the paged KV cache.

    Every slot advances by up to T tokens in the same step — prefilling slots
    feed a prompt chunk (n_new up to T), decoding slots feed one token
    (n_new = 1), idle slots feed nothing (n_new = 0). The three ragged
    quantities (per-slot position, per-slot length, per-slot activity) are all
    masks; the step's shape depends only on (S_slots, T).

    Writes go through each slot's block table: token `lengths[s] + t` lands in
    physical block `block_tables[s, (lengths[s]+t) // block_size]`; padded
    tokens write nothing (`_scatter_rows`). UNLIKE the JAX package, which
    returns new pool arrays, the pools (`kc`, `vc` and, for int8, the scale
    pools) are UPDATED IN PLACE and only the block's output is returned.
    Reads go through kernels.paged_attention.paged_pool_attention, which walks
    the slot's live blocks in place, so the attention math equals that of a
    contiguous cache of the same length — which is what makes engine output
    equal to single-request decoding.

    int8 cache (kc.dtype == int8): appended K/V are smoothed and
    absmax-quantized per (token, kv-head) (`quantize_kv`), scales scatter into
    their own pools through the same block table, and the kernel dequantizes
    on read."""
    b, t, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.n_heads_eff, cfg.n_kv_heads
    bs = kc.shape[1]
    int8_kv = kc.dtype == torch.int8

    q, k, v = linear_group(
        x, (p["wq"], p["wk"], p["wv"]),
        (p.get("bq"), p.get("bk"), p.get("bv")), cfg)
    q = q.reshape(b, t, nh, hd)
    k = k.reshape(b, t, nkv, hd)
    v = v.reshape(b, t, nkv, hd)
    steps = torch.arange(t, dtype=lengths.dtype, device=x.device)
    pos = lengths[:, None] + steps[None, :]                              # (S, T)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)

    # scatter this step's K/V into the slots' blocks
    valid = (steps[None, :] < n_new[:, None]).reshape(-1)
    blk = torch.gather(block_tables, 1, torch.clamp(
        pos // bs, max=block_tables.shape[1] - 1).long())               # (S, T)
    idx = (blk.long() * bs + (pos % bs).long()).reshape(-1)
    k = k.reshape(b * t, nkv, hd)
    v = v.reshape(b * t, nkv, hd)
    if int8_kv:
        kq8, ks8 = quantize_kv(k, k_smooth)
        vq8, vs8 = quantize_kv(v, v_smooth)
        _scatter_rows(kc, idx, kq8, valid)
        _scatter_rows(vc, idx, vq8, valid)
        _scatter_rows(kc_scale, idx, ks8, valid)
        _scatter_rows(vc_scale, idx, vs8, valid)
    else:
        _scatter_rows(kc, idx, k.to(kc.dtype), valid)
        _scatter_rows(vc, idx, v.to(vc.dtype), valid)

    o = paged_pool_attention(
        q.contiguous(), kc, vc, block_tables, lengths, n_new, int(layer_window),
        k_scale=kc_scale, v_scale=vc_scale, k_smooth=k_smooth,
        v_smooth=v_smooth, softcap=cfg.attn_softcap)
    return linear(o.reshape(b, t, nh * hd), p["wo"])


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_block(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        gate, up = linear_group(x, (p["w_gate"], p["w_up"]),
                                (None, None), cfg)
        return linear(F.silu(gate) * up, p["w_down"])
    h = F.gelu(linear(x, p["w_up"], p.get("b_up")), approximate="tanh")
    return linear(h, p["w_down"], p.get("b_down"))
