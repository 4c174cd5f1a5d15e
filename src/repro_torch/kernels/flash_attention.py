"""Flash attention for Hopper — the counterpart of the JAX package's Pallas
kernel `flash_attention`.

Online-softmax attention over (BH, S, D) with causal, sliding-window,
softcap, `q_offset` and `k_len` masks (kernels/csrc/flash_attention.cu): one
thread block owns `bq` query rows of one (batch * head), and each softmax
step takes `bk` keys, streamed through shared memory. On a CUDA tensor the
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

_MAX_D = 256            # the kernel keeps a row's channels in 8 registers per lane
_SCORE_TILE = 8192      # floats of the shared score tile: bk may not exceed it


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
    bk: Optional[int] = None,  # keys per softmax step; None -> tuned
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
    if d > _MAX_D or bk > _SCORE_TILE:
        raise ValueError(f"flash_attention: on the card D <= {_MAX_D} and bk <= "
                         f"{_SCORE_TILE}; got D {d}, bk {bk}")
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
