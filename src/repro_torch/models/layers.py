"""Layer library of the dense transformer family: the paged attention block
of the continuous-batching engine, and the contiguous-cache attention block
of the static-batch path and of the full-sequence forward (train, prefill,
evaluation).

Everything is functional: `fn(params_subtree, inputs, cfg, ...) -> outputs`,
on plain tensors and nested dicts of tensors. Names and conventions are those
of the JAX package's `models/layers.py`.

On a serving mesh (`launch/engine.py ServingEngine(mesh=)`) a weight or a
pool cut over the model axis arrives as a `distributed/sharding.py Sharded`:
`linear` / `linear_group` run each model rank's LUT projection on its column
shard (B1-B4 on the card), `paged_attn_block` runs B5 on each rank's kv
heads with the query heads of their groups, and the parts combine at the
`maybe_shard` calls, where the JAX package places its sharding constraints.
On one device every value is a tensor and those calls return it unchanged.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.core.api import _unpack_codes, is_clustered
from repro_torch.distributed.sharding import Sharded, device_of, gather, maybe_shard
from repro_torch.kernels.ops import clustered_linear, clustered_linear_multi
from repro_torch.kernels.paged_attention import paged_pool_attention
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# Linear / norms
# ---------------------------------------------------------------------------

def resolve_weight(w, dtype) -> torch.Tensor:
    """Dense view of a (possibly clustered, possibly stacked-expert) weight:
    codebook[codes] / smooth, in `dtype`.

    A clustered leaf is resolved one codebook at a time (once for a plain
    (K,) codebook, once per expert for a stacked (E, K) one) with int32
    indices into one `dtype` output: every element is `(codebook[e][code] /
    smooth[e][i])` computed alone, so the bits are those of resolving the
    whole tensor at once, while the transient is one expert's (d_in, d_out)
    instead of the whole stack's int64 indices and f32 copies."""
    if not is_clustered(w):
        return w.to(dtype)
    d_in, d_out = w.smooth.shape[-1], w.codes.shape[-1]
    lead = tuple(w.codebook.shape[:-1])
    out = torch.empty(lead + (d_in, d_out), dtype=dtype, device=w.codebook.device)
    flat_out = out.view(-1, d_in, d_out)
    codes = w.codes.reshape((-1,) + tuple(w.codes.shape[-2:]))
    cbs = w.codebook.reshape(-1, w.codebook.shape[-1])
    smooth = w.smooth.reshape(-1, d_in)
    for e in range(cbs.shape[0]):
        idx = _unpack_codes(codes[e], d_in, w.nbits)              # int32
        dense = cbs[e].index_select(0, idx.reshape(-1)).view(d_in, d_out)
        flat_out[e].copy_(dense / smooth[e][:, None])
    return out


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense projection. `w` may be a plain tensor or an LCD ClusteredTensor;
    clustered weights go through kernels.ops.clustered_linear (the fused
    smooth+quant+LUT kernels on CUDA tensors). A `Sharded` w (a serving
    mesh) gives a `Sharded` result: `_sharded_linear`."""
    if isinstance(w, Sharded):
        return _sharded_linear(x, w, b)
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
    if any(isinstance(w, Sharded) for w in ws):
        return _sharded_group(x, ws, bs, cfg)
    if (cfg.fused_projections and len(ws) > 1
            and all(is_clustered(w) for w in ws)):
        ys = clustered_linear_multi(x, ws)
    else:
        ys = tuple(linear(x, w) for w in ws)
    return tuple(y if b is None else y + b.to(y.dtype)
                 for y, b in zip(ys, bs))


def _on(x, part):
    """`x` on the device of a model rank's part (the same tensor where that
    is x's device: a mesh whose devices repeat moves nothing)."""
    return x.to(device_of(part))


def _column_cut(w: Sharded) -> bool:
    """Whether a per-layer (K, N) weight is cut on its output columns."""
    return w.dim == 1


def _sharded_linear(x: torch.Tensor, w: Sharded, b=None):
    """`linear` over a weight cut on the model axis: each rank's product on
    its column shard, a `Sharded` result cut on the last dim (the caller
    gathers it at a `maybe_shard`). The canonical K order of the LUT kernels
    makes every output column the same sum whatever N, so a column shard
    gives those columns' bits of the whole launch. A bias cut like the
    columns is added per rank; a whole one after the gather."""
    if not _column_cut(w):
        raise NotImplementedError(
            f"linear: a weight cut on dim {w.dim} (along K) is row-parallel; the "
            f"serving placement cuts every projection by its output columns "
            f"(distributed/layout.py serving_names)")
    ys = [linear(_on(x, p), p) for p in w.parts]
    if b is None:
        return Sharded(tuple(ys), ys[0].ndim - 1)
    if isinstance(b, Sharded):
        return Sharded(tuple(y + bb.to(y.dtype) for y, bb in zip(ys, b.parts)), ys[0].ndim - 1)
    y = gather(ys, ys[0].ndim - 1)
    return y + b.to(y.dtype)


def _sharded_group(x: torch.Tensor, ws, bs, cfg: ModelConfig):
    """`linear_group` over weights cut on the model axis: where every
    weight is cut by its columns, each rank runs the group fused on its
    shards (one B3 / B4 launch a rank), the outputs `Sharded`; otherwise
    each projection alone."""
    if all(isinstance(w, Sharded) and _column_cut(w) for w in ws) and all(
            b is None or isinstance(b, Sharded) for b in bs):
        per_rank = [linear_group(_on(x, parts[0]), parts,
                                 [None if b is None else b.parts[m] for b in bs], cfg)
                    for m, parts in enumerate(zip(*(w.parts for w in ws)))]
        return tuple(Sharded(tuple(out), out[0].ndim - 1) for out in zip(*per_rank))
    return tuple(linear(x, w, b) for w, b in zip(ws, bs))


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
                scale: float, k_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Cq, H, D); k/v: (B, Sk, KV, D) with KV | H. Returns (B, Cq, H, D).

    As in the JAX package, scores are taken in f32 and then held in bf16 on a
    bf16 model (the row sum stays f32); the probabilities meet V in that dtype
    with an f32 result. `window` is a Python int (0 = global);
    `q_pos` (Cq,) and `k_pos` (Sk,) are positions on q's device.

    Ragged batches (whisper's serving step over per-slot state): `q_pos` may
    be (B, Cq), each row's absolute positions, and `k_len` a (B,) count of
    valid keys per row; keys at or beyond `k_len` are masked out, and the mask
    is then (B, Cq, Sk)."""
    b, cq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    cdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    qf = q.to(torch.float32).reshape(b, cq, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32)) * scale
    scores = _softcap(scores, softcap).to(cdt)
    if q_pos.ndim == 1:                 # shared positions: the mask is (Cq, Sk)
        qp, kp = q_pos[:, None], k_pos[None, :]
    else:                               # per-row positions: (B, Cq, Sk)
        qp, kp = q_pos[:, :, None], k_pos[None, None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    if k_len is not None:
        mask = (mask if mask.ndim == 3 else mask[None]) & (kp < k_len[:, None, None])
    if mask.ndim == 3:
        mask = mask[:, None, None]      # over the (kv head, group) axes
    scores = torch.where(mask, scores, torch.full((), -torch.inf, dtype=cdt,
                                                  device=q.device))
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=-1e30)  # fully masked rows
    e = torch.exp(scores - m)
    ssum = e.to(torch.float32).sum(dim=-1, keepdim=True)
    probs = e / torch.clamp(ssum, min=1e-30).to(cdt)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(torch.float32),
                       v.to(cdt).to(torch.float32))
    return out.reshape(b, cq, h, d).to(q.dtype)


# the query rows of one ragged attention block (`ragged_attention`)
_RAGGED_Q_ROWS = 32


def ragged_attention(q, k, v, q_pos, k_pos, *, causal: bool, scale: float,
                     k_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`_attn_chunk` over per-row positions `q_pos` (B, Cq) (and `k_len`,
    (B,) valid keys per row), the queries taken in blocks of exactly 32
    rows, the last one padded with zero queries that are sliced away.

    cuBLAS picks its batched product's kernel by the shape: on an H100 a
    query row's f32 scores had other bits in a (B·H, 1, D) × (B·H, D, Sk)
    product than as a row of (B·H, 32, D), and at one row other bits again
    at another batch count. A slot feeds one token in a decode step but sits
    in a 32-row window in a mixed step (a decoding slot among prefilling
    ones), and its rows must get the same bits in both, alone or among 8
    slots: with every block 32 rows, every product and every reduction of
    the softmax has one shape, whatever the window's width or the slot
    count."""
    cq = q.shape[1]
    pad = -cq % _RAGGED_Q_ROWS
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad))
    outs = [_attn_chunk(q[:, i:i + _RAGGED_Q_ROWS], k, v, q_pos[:, i:i + _RAGGED_Q_ROWS],
                        k_pos, causal=causal, window=0, softcap=0.0, scale=scale,
                        k_len=k_len)
            for i in range(0, cq + pad, _RAGGED_Q_ROWS)]
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1))[:, :cq]


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
    on read.

    On a mesh the pools are `Sharded`: cut on kv heads, each model rank
    attends over its own (`_attend` on its parts of q, k, v and the pool);
    whole (kv heads the model axis does not divide), q, k and v are gathered
    and attended once. The output is gathered for `wo`, whose output
    columns are cut, and gathered again for the residual."""
    q, k, v = linear_group(
        x, (p["wq"], p["wk"], p["wv"]),
        (p.get("bq"), p.get("bk"), p.get("bv")), cfg)
    pool = dict(kc=kc, vc=vc, kc_scale=kc_scale, vc_scale=vc_scale, k_smooth=k_smooth,
                v_smooth=v_smooth)
    args = (cfg, int(layer_window), block_tables, lengths, n_new)
    if not isinstance(kc, Sharded):
        o = _attend(q, k, v, pool, *args)
    elif kc.dim is None:
        # kv heads the model axis does not divide: the pool is whole on every
        # rank, and so are the heads that attend over it
        q, k, v = (maybe_shard(a, "slots", None, None) for a in (q, k, v))
        o = _attend(q, k, v, _pool_part(pool, 0), *args)
    else:
        # each model rank: B5 over its kv heads with the query heads of their
        # groups (its columns of wq, wk and wv are exactly those heads)
        if not all(isinstance(a, Sharded) for a in (q, k, v)):
            raise ValueError("paged_attn_block: the pool is cut on kv heads but the "
                             "QKV projections are not cut alike")
        o = Sharded(tuple(_attend(q.parts[m], k.parts[m], v.parts[m], _pool_part(pool, m),
                                  *args) for m in range(len(kc.parts))), 2)
    o = maybe_shard(o, "slots", None, None)
    return maybe_shard(linear(o, p["wo"]), "slots", None, "embed")


def _pool_part(pool: Dict[str, Any], m: int) -> Dict[str, Any]:
    """Model rank m's part of every pool tensor."""
    return {name: None if t is None else t.parts[m] for name, t in pool.items()}


def _attend(q, k, v, pool, cfg: ModelConfig, layer_window: int, block_tables,
            lengths, n_new) -> torch.Tensor:
    """The paged block's attention over one rank's heads: q (S, T, Hq·D),
    k / v (S, T, Hkv·D) get RoPE, this step's K / V are scattered into
    `pool` (the rank's part; the int8 pools quantized first) and B5 reads
    it. Returns (S, T, Hq·D)."""
    b, t, _ = q.shape
    hd = cfg.hd
    dev = q.device
    block_tables, lengths, n_new = (a.to(dev) for a in (block_tables, lengths, n_new))
    kc = pool["kc"]
    bs = kc.shape[1]
    q = q.reshape(b, t, -1, hd)
    k = k.reshape(b, t, -1, hd)
    v = v.reshape(b, t, -1, hd)
    nkv = k.shape[2]
    steps = torch.arange(t, dtype=lengths.dtype, device=dev)
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
    if kc.dtype == torch.int8:
        kq8, ks8 = quantize_kv(k, pool["k_smooth"])
        vq8, vs8 = quantize_kv(v, pool["v_smooth"])
        writes = (("kc", kq8), ("vc", vq8), ("kc_scale", ks8), ("vc_scale", vs8))
    else:
        writes = (("kc", k.to(kc.dtype)), ("vc", v.to(kc.dtype)))
    for name, vals in writes:
        _scatter_rows(pool[name], idx, vals, valid)

    o = paged_pool_attention(
        q.contiguous(), kc, pool["vc"], block_tables, lengths, n_new, layer_window,
        k_scale=pool["kc_scale"], v_scale=pool["vc_scale"], k_smooth=pool["k_smooth"],
        v_smooth=pool["v_smooth"], softcap=cfg.attn_softcap)
    return o.reshape(b, t, -1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_block(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The dense MLP (SwiGLU or gelu). On a mesh each model rank runs its
    columns of the up projections; they are gathered and the activation
    runs on the whole hidden, as on one device (the CPU's vectorised silu /
    gelu can give an element other bits in a tensor of another size), for
    `w_down`, whose output columns are cut too and gathered again for the
    residual."""
    if cfg.mlp == "swiglu":
        gate, up = linear_group(x, (p["w_gate"], p["w_up"]),
                                (None, None), cfg)
        h = F.silu(maybe_shard(gate, "batch", None, None)) * maybe_shard(
            up, "batch", None, None)
    else:
        h = F.gelu(maybe_shard(linear(x, p["w_up"], p.get("b_up")), "batch", None, None),
                   approximate="tanh")
    return maybe_shard(linear(h, p["w_down"], p.get("b_down")), "batch", None, "embed")


# ---------------------------------------------------------------------------
# MoE (grouped, capacity-based)
# ---------------------------------------------------------------------------

# The JAX package's `moe_block(capacity_factor=1.25, group_size=512)`
# defaults, which nothing there overrides.
MOE_CAPACITY_FACTOR = 1.25
MOE_GROUP_SIZE = 512


@contextlib.contextmanager
def _full_f32_matmuls():
    """Inside, f32 matmuls run in full f32 whatever the caller set (TF32
    off). A host-side setting, so it is free under a CUDA-graph capture."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class _FullF32Einsum(torch.autograd.Function):
    """`torch.einsum(eq, *operands)` whose forward and backward products all
    run in full f32 (`_full_f32_matmuls`): autograd runs a backward after the
    forward's `with` block has exited, under whatever the caller set then.
    The router's logits decide the routing, the dispatch product is a gather
    only in exact f32, and the recurrent families' chunked forms sum
    exponentials of cumulative decays. Each operand's gradient is the einsum
    of the output's gradient with the other operands, so every index of an
    operand must appear in another operand or in the output (true of every
    product the port runs through it)."""

    @staticmethod
    def forward(ctx, eq: str, *operands: torch.Tensor) -> torch.Tensor:
        ctx.eq = eq
        ctx.save_for_backward(*operands)
        with _full_f32_matmuls():
            return torch.einsum(eq, *operands)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        operands = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        subs = ins.split(",")
        grads = []
        with _full_f32_matmuls():
            for i, sub in enumerate(subs):
                if not ctx.needs_input_grad[i + 1]:
                    grads.append(None)
                    continue
                rest = [j for j in range(len(subs)) if j != i]
                eq_i = ",".join([out] + [subs[j] for j in rest]) + "->" + sub
                grads.append(torch.einsum(eq_i, g, *[operands[j] for j in rest]))
        return (None, *grads)


def _einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    return _FullF32Einsum.apply(eq, *operands)


def row_stable_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in full f32 (forward and backward, `_FullF32Einsum`) for the
    small f32 products of a recurrent step (the decay / gate LoRA). cuBLAS
    picks its kernel by the row count: on an H100 a (1, 2048) x (2048, 64)
    row has other bits than the same row inside (8, 2048), and a
    (M, 64) x (64, 2048) row differs between 1 and 8 rows. So, as the norms
    take their statistics (`_MIN_STAT_ROWS`), fewer than 16 rows are padded
    with zero rows to 16: a row's bits are the same at 1 to 16 rows, which
    covers a slot at batch 1 (plain decode) and inside the engine's step."""
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, k)
    r = rows.shape[0]
    if r < _MIN_STAT_ROWS:
        rows = F.pad(rows, (0, 0, 0, _MIN_STAT_ROWS - r))
    return _einsum("mk,kn->mn", rows, w)[:r].reshape(*lead, w.shape[-1])


class MoeRouting(NamedTuple):
    """The routing of one `moe_block` call: (G, Sg, E, C) dispatch (0/1) and
    combine (the gate where dispatched) tensors in f32, the Switch-style aux
    loss and the capacity C. A (token, top-k slot) pair that dropped is
    dispatched nowhere."""
    dispatch: torch.Tensor
    combine: torch.Tensor
    aux: torch.Tensor
    cap: int


def moe_groups(t: int) -> Tuple[int, int]:
    """(G, Sg): the t tokens of a call in G groups of Sg, Sg the largest
    power-of-two fraction of min(MOE_GROUP_SIZE, t) that divides t."""
    sg = min(MOE_GROUP_SIZE, t)
    while t % sg:
        sg //= 2
    return t // sg, sg


def moe_routing(router: torch.Tensor, xt: torch.Tensor, n_experts: int,
                topk: int) -> MoeRouting:
    """Top-k routing with per-group expert capacity, as the JAX package's
    `moe_block` routes: xt (G, Sg, d); f32 router logits and softmax; the
    aux loss E * sum(mean prob * share of argmax); for each of the top-k
    slots the argmax of the gates not taken yet (first index on a tie),
    the token's place at its expert counted over the group in token order
    after every earlier slot's tokens, and a drop at or past the capacity
    C = ceil(Sg * topk * MOE_CAPACITY_FACTOR / E / 4) * 4 (at most Sg).

    One-hots are comparisons with an arange, so a place past the capacity
    is a zero row (as `jax.nn.one_hot` gives) and nothing checks an index
    on the host."""
    g, sg, _ = xt.shape
    e = n_experts
    cap = min(int(np.ceil(sg * topk * MOE_CAPACITY_FACTOR / e / 4.0) * 4), sg)
    dev = xt.device
    experts_r = torch.arange(e, device=dev)
    places_r = torch.arange(cap, device=dev)
    logits = _einsum("gsd,de->gse", xt.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)

    me = probs.mean(dim=(0, 1))
    top = (torch.argmax(probs, dim=-1)[..., None] == experts_r).to(torch.float32)
    aux = e * torch.sum(me * top.mean(dim=(0, 1)))

    gates_rem = probs
    dispatch = torch.zeros((g, sg, e, cap), dtype=torch.float32, device=dev)
    combine = torch.zeros_like(dispatch)
    prev_count = torch.zeros((g, 1, e), dtype=torch.float32, device=dev)
    for _ in range(topk):
        idx = torch.argmax(gates_rem, dim=-1)                       # (G, Sg)
        onehot = (idx[..., None] == experts_r).to(torch.float32)    # (G, Sg, E)
        gate = torch.sum(probs * onehot, dim=-1, keepdim=True)      # (G, Sg, 1)
        pos = torch.cumsum(onehot, dim=1) - onehot + prev_count     # (G, Sg, E)
        keep = (pos < cap).to(torch.float32) * onehot
        posc = (pos.to(torch.int32)[..., None] == places_r).to(torch.float32)
        disp = keep[..., None] * posc                               # (G, Sg, E, C)
        dispatch = dispatch + disp
        combine = combine + disp * gate[..., None]
        prev_count = prev_count + torch.sum(onehot, dim=1, keepdim=True)
        gates_rem = gates_rem * (1.0 - onehot)
    return MoeRouting(dispatch, combine, aux, cap)


def moe_block(p: Dict[str, Any], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with per-group expert capacity (Mesh-TF style dense
    dispatch), the JAX package's `moe_block`: x (B, S, d) -> (out (B, S, d),
    aux f32).

    All B * S tokens of the call are routed together (`moe_routing`), so a
    token dropped for capacity depends on what else shares the call: the
    idle slots' pad tokens of a serving step too. The dispatch product
    gathers each expert's tokens (exact: one non-zero term per output), the
    experts' SwiGLU runs as one batched product per weight over the
    (E, G, C, d) tokens, with the stacked weights resolved by
    `resolve_weight` one at a time, and the combine product sums each
    token's kept experts' outputs weighted by their gates. Every f32 product,
    forward and backward, runs in full f32 whatever the caller's TF32
    setting (`_FullF32Einsum`)."""
    b, s, d = x.shape
    g, sg = moe_groups(b * s)
    xt = x.reshape(g, sg, d)
    with record_function("moe.routing"):
        r = moe_routing(p["router"], xt, cfg.n_experts, cfg.moe_topk)
    with record_function("moe.dispatch_combine"):
        xe = _einsum("gsec,gsd->egcd", r.dispatch,
                     xt.to(torch.float32)).to(x.dtype)                  # (E, G, C, d)
    # per-expert SwiGLU: weights (E, d, f) / (E, f, d), possibly clustered,
    # resolved one weight at a time
    h = F.silu(_expert_product("egcd,edf->egcf", xe, p["w_gate"]))
    h = h * _expert_product("egcd,edf->egcf", xe, p["w_up"])
    ye = _expert_product("egcf,efd->egcd", h, p["w_down"])
    with record_function("moe.dispatch_combine"):
        out = _einsum("gsec,egcd->gsd", r.combine.to(x.dtype), ye)
    return out.reshape(b, s, d), r.aux


def _expert_product(eq: str, a: torch.Tensor, w) -> torch.Tensor:
    """One batched product of `a` with a stacked-expert weight, resolved in
    a's dtype just before and dropped just after. The profiler ranges name
    the two parts of an MoE layer's time."""
    with record_function("moe.resolve_weight"):
        dense = resolve_weight(w, a.dtype)
    with record_function("moe.expert_matmul"):
        return _einsum(eq, a, dense)
