"""Flash attention for Hopper — the counterpart of the JAX package's Pallas
kernel `flash_attention`.

Online-softmax attention over (BH, S, D) with causal, sliding-window,
softcap, `q_offset` and `k_len` masks (kernels/csrc/flash_attention.cu): one
thread block owns `bq` query rows of one (batch * head). The kernel is
chosen by dtype: bf16 runs both products on the tensor cores (`mma.sync`,
passes of 128 rows, softmax steps of the kernel's own 32-key chunks, so `bk`
only has to divide Sk); f32 runs on the CUDA cores in f32, each softmax step
taking `bk` keys. `card_tile` holds the card's rules for a tile and is
checked before every launch. On a CUDA tensor the
wrapper launches the kernel on the current stream and counts the launch; on
a CPU tensor it runs the plain version (kernels/ref.py flash_attention_ref).
With `bq` or `bk` left as None the tile comes from the tuner
(kernels/autotune.py): on the card a cache miss measures every candidate, on
the CPU it is the cached winner or the heuristic.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.ref import flash_attention_ref

# launches of the kernel since the last reset (a plain int; see kernels/ops.py)
LAUNCHES = {"flash_attention": 0}

_MAX_D = 256            # both kernels size their register arrays for D <= 256
_SCORE_TILE = 8192      # f32: floats of the shared score tile, bk may not exceed it
_MMA_ROWS = 128         # bf16: query rows per pass (8 warps of 16)
_MMA_KEYS = 32          # bf16: keys per chunk, the softmax step
_MMA_STAGES = 3         # bf16: stages of the K / V ring
_MMA_PAD = 8            # bf16: padding of a shared-memory row, in elements
_SMEM_LIMIT = 232448    # shared memory one thread block may use on an H100


def card_tile(d: int, bq: int, bk: int, dtype) -> dict:
    """The card's rules for a (bq, bk) tile at head width `d` and `dtype`,
    the same arithmetic as the kernels' launchers: raises ValueError for a
    tile the card cannot run (so the tuner lets it lose before anything
    launches), TypeError for a dtype it has no kernel for. Returns the
    kernel the tile runs and its shape: bf16 pads D to 16 in shared memory,
    walks bq rows in passes of 128 and steps the softmax in chunks of 32
    keys (bk only has to divide Sk); f32 keeps bk as the softmax step in a
    shared score tile of <= 8192 floats."""
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"flash_attention: on the card 1 <= D <= {_MAX_D}; got D {d}")
    if bq < 1 or bk < 1:
        raise ValueError(f"flash_attention: bq and bk must be >= 1; got {bq}, {bk}")
    if dtype == torch.bfloat16:
        d_pad = -(-d // 16) * 16
        smem = 2 * (_MMA_ROWS + 2 * _MMA_STAGES * _MMA_KEYS) * (d_pad + _MMA_PAD)
        out = dict(kernel="tensor_cores", d_pad=d_pad, rows_per_pass=_MMA_ROWS,
                   key_step=_MMA_KEYS, smem_bytes=smem)
    elif dtype == torch.float32:
        if bk > _SCORE_TILE:
            raise ValueError(f"flash_attention: on the card an f32 step takes bk <= "
                             f"{_SCORE_TILE} keys; got bk {bk}")
        rows = min(bq, 64, _SCORE_TILE // bk)
        d_pad = -(-d // 4) * 4
        out = dict(kernel="cuda_cores", d_pad=d_pad, rows_per_pass=rows, key_step=bk,
                   smem_bytes=4 * (rows * d_pad + rows * bk + d_pad * 65))
    else:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    if out["smem_bytes"] > _SMEM_LIMIT:
        raise ValueError(f"flash_attention: the tile needs {out['smem_bytes']} bytes of "
                         f"shared memory, one thread block holds at most {_SMEM_LIMIT}")
    return out


def _check_operands(q, k, v):
    name = "flash_attention"
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: q must be (BH, Sq, D) and k, v (BH, Sk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} must agree "
                         f"in BH and D")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must all be float32 or all bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous; got strides {t.stride()} "
                             f"for shape {tuple(t.shape)}")


def _flash_measure_fn(bh: int, sq: int, sk: int, d: int, dtype, device, kw: dict):
    """measure(bq, bk) -> seconds on synthetic (bh, s, d) operands on the
    card, made from a seeded generator at the first measurement; timing
    depends on shapes and masks, not on values."""
    ops = []

    def measure(bq: int, bk: int) -> float:
        if not ops:
            g = torch.Generator(device=device).manual_seed(0)
            ops.extend(torch.randn((bh, s, d), generator=g, device=device).to(dtype)
                       for s in (sq, sk, sk))
        return autotune.measure_candidate(
            lambda: flash_attention(*ops, bq=bq, bk=bk, **kw))

    return measure


def flash_attention(
    q: torch.Tensor,          # (BH, Sq, D) — batch*heads flattened
    k: torch.Tensor,          # (BH, Sk, D)
    v: torch.Tensor,          # (BH, Sk, D)
    *,
    bq: Optional[int] = None,  # query rows per thread block; None -> tuned
    bk: Optional[int] = None,  # keys per softmax step (f32); None -> tuned
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
    k_len: int = 0,           # > 0: mask keys at positions >= k_len (padded cache)
) -> torch.Tensor:
    """Attention of query row i (position q_offset + i) over the keys it may
    see (causal, window, k_len), scores scaled by 1/sqrt(D) and optionally
    softcapped, in f32; returns q's dtype. `bq = min(bq, Sq)` and
    `bk = min(bk, Sk)` must divide Sq and Sk (ValueError otherwise, as the
    reference asserts)."""
    _check_operands(q, k, v)
    bh, sq, d = q.shape
    sk = k.shape[1]
    kw = dict(causal=causal, window=int(window), softcap=float(softcap),
              q_offset=int(q_offset), k_len=int(k_len))
    if bq is None or bk is None:
        measure = None
        if q.device.type == "cuda":
            measure = _flash_measure_fn(bh, sq, sk, d, q.dtype, q.device, kw)
        tbq, tbk = autotune.pick_flash_blocks(sq, sk, d, device=q.device, measure=measure)
        bq, bk = bq or tbq, bk or tbk
    bq, bk = min(int(bq), sq), min(int(bk), sk)
    if bq < 1 or bk < 1 or sq % bq or sk % bk:
        raise ValueError(f"flash_attention: the tile must divide the problem: Sq {sq} % "
                         f"bq {bq}, Sk {sk} % bk {bk}")
    if q.device.type != "cuda":
        return flash_attention_ref(q, k, v, **kw)
    card_tile(d, bq, bk, q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _build.library().flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), bh, sq, sk, d, bq, bk, int(bool(causal)),
            kw["window"], kw["softcap"], kw["q_offset"], kw["k_len"],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
