"""Paged attention for Hopper — the counterparts of the JAX package's Pallas
kernels `paged_pool_attention` (B5) and `paged_dequant_attention` (B8).

The kernel (kernels/csrc/paged_attention.cu) reads the paged KV pools in
place through the block tables: per decode step the cache traffic is each
slot's true length, not a table-width-padded gathered copy. One kernel serves
float (f32 / bf16) and int8 pools; int8 pools dequantize on chip as
codes · scale[token, head] · smooth[head, :]. A thread block takes up to 32
query rows of one (slot, kv-head) and reads each of the slot's keys once;
`pool_plan` holds the card's rules for that block (rows, the staging ring,
shared memory, grid) and is checked before every launch. Every row follows
one canonical key order (32-key chunks folded left in key order,
csrc/paged_attention.cuh), so its bits do not depend on T, the grid or the
staging. On a CUDA tensor the wrapper launches the kernel on the current
stream and counts the launch; on a CPU tensor it runs the plain version
(kernels/ref.py paged_pool_attention_ref).

`paged_dequant_attention` (kernels/csrc/paged_dequant.cu) attends over an
already-gathered int8 view (S, L, KV, D) with the same block body, so on a
view gathered from a pool it gives the same bits as `paged_pool_attention` on
that pool. Its `l_pad` (keys staged in shared memory at a time, a multiple of
the 32-key chunk) comes from the tuner (kernels/autotune.py) when left as
None; every `l_pad` gives the same bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.ref import paged_dequant_attention_ref, paged_pool_attention_ref

# launches of each kernel since the last reset (plain ints; see kernels/ops.py)
LAUNCHES = {"paged_pool_attention": 0, "paged_dequant_attention": 0}

_POOL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_D = 256
_MAX_SMEM = 232448          # bytes of shared memory one thread block may use

# the block body's constants (csrc/paged_attention.cuh)
CHUNK = 32                  # keys per chunk: the segment of the canonical per-row order
_WARPS = 8
_MAX_ROWS = 32              # query rows of one thread block
_MAX_RG = 4                 # rows of one warp's group
_ROW_PAD = 16               # bytes after each staged key row
_STAGES = 2                 # buffers of the staging ring


def pool_plan(t: int, h: int, kv: int, d: int, pool_dtype, *, s_slots: int = 1,
              stage_keys: Optional[int] = None, name: str = "paged_pool_attention") -> dict:
    """The card's rules for one launch of the paged attention block body, the
    same arithmetic as csrc/paged_attention.cuh make_plan: raises ValueError
    for what the card cannot run, before anything is launched.

    A thread block owns rows = min(32, g·T) query rows of one (slot,
    kv-head): groups of rg rows (1 up to 8 rows, 2 up to 16, else 4), one warp
    each; with rows <= 4 the 8 warps split a row's chunks (`warps_per_row`).
    Keys arrive `stage_keys` at a time (a multiple of the 32-key chunk)
    through a ring of 2 buffers, each staged key row D elements of the pool's
    type plus 16 bytes. Unless given (B8 stages l_pad keys), a stage is 96
    keys where the warps split a row's chunks (3 chunks a stage) and 64
    otherwise, or 32 where that does not fit (measured on an H100: PERF.md).
    None of these choices changes a bit of the result."""
    if d % 32 or not 32 <= d <= _MAX_D:
        raise ValueError(f"{name}: on the card the head dim must be a multiple of 32 "
                         f"and <= {_MAX_D}; got {d}")
    if kv < 1 or h % kv or t < 1 or s_slots < 1:
        raise ValueError(f"{name}: need T, S >= 1 and KV | H; got T {t}, S {s_slots}, "
                         f"H {h}, KV {kv}")
    g = h // kv
    rows = min(_MAX_ROWS, g * t)
    rg = 1 if rows <= 8 else 2 if rows <= 16 else _MAX_RG
    groups = -(-rows // rg)
    split = _WARPS // groups if rg == 1 and groups <= 4 else 1
    elt = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[pool_dtype]
    int8 = pool_dtype == torch.int8
    row_bytes = d * elt + _ROW_PAD

    def smem(sk):
        floats = (groups * rg * d + _WARPS * _MAX_RG * CHUNK + (d if int8 else 0)
                  + (2 * groups * (sk // CHUNK) * (d + 4) if split > 1 else 0))
        return floats * 4 + _STAGES * (2 * sk * row_bytes + (2 * sk * 4 if int8 else 0))

    if stage_keys is None:
        stage_keys = next((sk for sk in ((96, 64, 32) if split > 1 else (64, 32))
                           if smem(sk) <= _MAX_SMEM), 32)
    stage_keys = int(stage_keys)
    if stage_keys < CHUNK or stage_keys % CHUNK:
        raise ValueError(f"{name}: keys are staged in whole {CHUNK}-key chunks; got "
                         f"{stage_keys}")
    nbytes = smem(stage_keys)
    if nbytes > _MAX_SMEM:
        raise ValueError(f"{name}: {stage_keys} keys a stage at D {d} take {nbytes} bytes; "
                         f"one thread block holds at most {_MAX_SMEM}")
    return dict(chunk=CHUNK, rows=rows, rows_per_warp=rg, groups=groups,
                warps_per_row=split, stage_keys=stage_keys, row_bytes=row_bytes,
                smem_bytes=nbytes, grid=(s_slots, kv, -(-(g * t) // rows)))


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
    plan = pool_plan(t, h, kv, d, k_pool.dtype, s_slots=s_slots)
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_pool_attention: k_pool and v_pool must be 16-byte aligned "
                         "for the kernel's vector copies")
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
            block_tables.shape[1], window, float(softcap), plan["rows"],
            plan["stage_keys"], torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "paged_pool_attention")
    LAUNCHES["paged_pool_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# B8: dequantizing attention over a gathered int8 view
# ---------------------------------------------------------------------------

def _check_dequant_operands(q, kq, k_scale, vq, v_scale, k_smooth, v_smooth, lengths,
                            n_new, window):
    name = "paged_dequant_attention"
    if q.ndim != 4 or kq.ndim != 4:
        raise ValueError(f"{name}: q must be (S,T,H,D) and kq (S,L,KV,D); got "
                         f"{tuple(q.shape)} and {tuple(kq.shape)}")
    s_slots, _, h, d = q.shape
    _, l, kv, _ = kq.shape
    if tuple(kq.shape[::3]) != (s_slots, d) or h % kv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match kq "
                         f"{tuple(kq.shape)} (S and D equal, KV | H)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16; got {q.dtype}")
    for nm, t in (("kq", kq), ("vq", vq)):
        if t.dtype != torch.int8 or t.shape != kq.shape:
            raise ValueError(f"{name}: {nm} must be int8 {tuple(kq.shape)}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = [("q", q), ("kq", kq), ("vq", vq)]
    for nm, t, shape in (("k_scale", k_scale, (s_slots, l, kv)),
                         ("v_scale", v_scale, (s_slots, l, kv)),
                         ("k_smooth", k_smooth, (kv, d)), ("v_smooth", v_smooth, (kv, d))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: {nm} must be float32 {shape}; got {t.dtype} "
                             f"{tuple(t.shape)}")
        tensors.append((nm, t))
    for nm, t in (("lengths", lengths), ("n_new", n_new)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {nm} must be int32; got {t.dtype}")
        if tuple(t.shape) != (s_slots,):
            raise ValueError(f"{name}: {nm} must be ({s_slots},); got {tuple(t.shape)}")
        tensors.append((nm, t))
    if isinstance(window, torch.Tensor):
        if window.ndim != 0 or window.dtype != torch.int32:
            raise ValueError(f"{name}: a window tensor must be 0-d int32; got "
                             f"{window.dtype} {tuple(window.shape)}")
        tensors.append(("window", window))
    for nm, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


def _check_dequant_card(q, kq, vq, l_pad):
    """What the card's kernel takes beyond the operands' shapes: raised before
    anything is launched (the tuner counts such a tile as refused). `l_pad` is
    the stage of the block body's staging ring, so it must be a whole number
    of 32-key chunks. Returns the launch's plan (`pool_plan`)."""
    name = "paged_dequant_attention"
    s_slots, t, h, d = q.shape
    plan = pool_plan(t, h, kq.shape[2], d, torch.int8, s_slots=s_slots, stage_keys=l_pad,
                     name=name)
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError(f"{name}: kq and vq must be 16-byte aligned for the kernel's "
                         f"vector loads")
    return plan


def _paged_measure_fn(s_slots: int, t: int, h: int, d: int, l: int, kv: int, dtype,
                      softcap: float, device):
    """measure(l_pad) -> seconds on a synthetic int8 view on the card, made
    from a seeded generator at the first measurement; timing depends on
    shapes, not on the cache contents."""
    ops = []

    def measure(l_pad: int) -> float:
        if not ops:
            g = torch.Generator(device=device).manual_seed(0)
            codes = lambda: torch.randint(-127, 128, (s_slots, l, kv, d), generator=g,  # noqa: E731
                                          dtype=torch.int8, device=device)
            sc = torch.full((s_slots, l, kv), 0.01, device=device)
            sm = torch.ones((kv, d), device=device)
            ops.extend([
                torch.randn((s_slots, t, h, d), generator=g, device=device).to(dtype),
                codes(), sc, codes(), sc, sm, sm,
                torch.full((s_slots,), max(l - t, 0), dtype=torch.int32, device=device),
                torch.full((s_slots,), t, dtype=torch.int32, device=device)])
        return autotune.measure_candidate(
            lambda: paged_dequant_attention(*ops, 0, softcap=softcap, l_pad=l_pad))

    return measure


def paged_dequant_attention(
    q: torch.Tensor,          # (S, T, H, D) float — post-rope queries
    kq: torch.Tensor,         # (S, L, KV, D) int8 — gathered logical K view
    k_scale: torch.Tensor,    # (S, L, KV) f32 — per-(token, kv-head) scales
    vq: torch.Tensor,         # (S, L, KV, D) int8
    v_scale: torch.Tensor,    # (S, L, KV) f32
    k_smooth: torch.Tensor,   # (KV, D) f32 — calibrated smoothing vector
    v_smooth: torch.Tensor,   # (KV, D) f32
    lengths: torch.Tensor,    # (S,) int32 — cached tokens per slot
    n_new: torch.Tensor,      # (S,) int32 — valid tokens in this window
    window,                   # sliding window (0 = global): int or 0-d int32 tensor
    *,
    softcap: float = 0.0,
    l_pad: Optional[int] = None,   # keys staged at a time; None -> tuned
) -> torch.Tensor:
    """Fused dequantize + masked attention over a slot's gathered int8 view.

    Query row r of a (slot, kv-head) is (group r // T, token r % T) at
    position lengths[s] + r % T; it sees column c iff c <= position,
    position - c < window (window > 0) and c < lengths[s] + n_new[s] (and
    c < L). A row with nothing visible gives zeros. Returns (S, T, H, D) in
    q's dtype. On the card a window tensor is read by the kernel, never by
    the host. With `l_pad` None a cache miss on the card measures every
    candidate, which synchronises: not inside CUDA-graph capture or a
    sync-debug region."""
    _check_dequant_operands(q, kq, k_scale, vq, v_scale, k_smooth, v_smooth, lengths, n_new,
                            window)
    s_slots, t, h, d = q.shape
    l, kv = kq.shape[1], kq.shape[2]
    gt = (h // kv) * t
    if l_pad is None:
        measure = None
        if q.device.type == "cuda":
            measure = _paged_measure_fn(s_slots, t, h, d, l, kv, q.dtype, softcap, q.device)
        l_pad = autotune.pick_paged_pad(gt, l, d, device=q.device, measure=measure)
    if q.device.type != "cuda":
        return paged_dequant_attention_ref(q, kq, k_scale, vq, v_scale, k_smooth, v_smooth,
                                           lengths, n_new, window, softcap=softcap)
    plan = _check_dequant_card(q, kq, vq, l_pad)
    win_t = window if isinstance(window, torch.Tensor) else None
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().paged_dequant_launch(
            q.data_ptr(), int(q.dtype == torch.bfloat16), kq.data_ptr(), k_scale.data_ptr(),
            vq.data_ptr(), v_scale.data_ptr(), k_smooth.data_ptr(), v_smooth.data_ptr(),
            lengths.data_ptr(), n_new.data_ptr(),
            None if win_t is None else win_t.data_ptr(), 0 if win_t is not None else int(window),
            out.data_ptr(), s_slots, t, h, kv, d, l, plan["rows"], plan["stage_keys"],
            float(softcap),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "paged_dequant_attention")
    LAUNCHES["paged_dequant_attention"] += 1
    return out

