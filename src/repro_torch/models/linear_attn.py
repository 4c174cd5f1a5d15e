"""Chunked (block-parallel) forms of the SSD / WKV6 / GLA recurrences, used by
the full-sequence forward (train, prefill, evaluation) of zamba2, rwkv6 and
gla when more than one token is fed.

The per-token recurrence carries the full state (B, H, P, N) from token to
token. The chunked form processes Q-token chunks with dense products and
materialises the state once per chunk (Mamba-2's SSD algorithm; Flash-Linear-
Attention's WKV form), at the cost of O(S·Q) extra operations.

Derivations (log-space cumulative decays, per chunk):
  SSD:   intra:  y[t] += Σ_{s<=t} exp(L_t - L_s) (C_t·B_s) dt_s x_s
         inter:  y[t] += exp(L_t) C_t · S_in
         state:  S_out = exp(L_Q) S_in + Σ_s exp(L_Q - L_s) dt_s x_s ⊗ B_s
  WKV6:  the same structure per key channel p with decay w_t[p]; the u bonus
         adds the diagonal term (r_t · u ⊙ k_t) v_t.
  GLA:   the inclusive-decay variant of WKV6 with no u bonus.

Exponents are clamped at ±CLAMP; a clamped entry is a contribution below
e^-30. Where the JAX package scans over chunks, this module loops over them
in Python. Every product runs in full f32 whatever the caller's TF32 setting,
forward and backward (`layers._einsum`): the sums of exponentials of
cumulative decays would not hold the forward = decode bound under TF32.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import _einsum

CLAMP = 30.0


def _chunk_len(s: int, chunk: int) -> int:
    """The chunk length: `chunk`, at most s, halved until it divides s."""
    q = min(chunk, s)
    while s % q:
        q //= 2
    return q


def _chunks(x: torch.Tensor, q: int):
    """(B, S, ...) -> the S / q chunks (B, q, ...), in order."""
    return x.split(q, dim=1)


# ---------------------------------------------------------------------------
# SSD (Mamba-2), single B/C group
# ---------------------------------------------------------------------------

def ssd_chunked(xh, Bt, Ct, dt, a_log, d_skip, s0, *, chunk: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh: (B,S,H,P) f32; Bt/Ct: (B,S,N); dt: (B,S,H) (post-softplus);
    s0: (B,H,P,N). Returns (y (B,S,H,P), s_final); matches
    `zamba2._ssd_scan`."""
    s = xh.shape[1]
    q = _chunk_len(s, chunk)
    la = -dt * torch.exp(a_log)[None, None, :]              # log decay (B,S,H) <= 0
    tri = torch.tril(torch.ones((q, q), dtype=torch.float32, device=xh.device))
    s_in, ys = s0, []
    for xc, bc, cc, dtc, lac in zip(*(_chunks(a, q) for a in (xh, Bt, Ct, dt, la))):
        L = torch.cumsum(lac, dim=1)                        # (B,Q,H) log cumulative decay
        Lq = L[:, -1:]                                      # (B,1,H) the chunk's total
        # intra-chunk: scores[t,s] = exp(L_t - L_s) * (C_t . B_s), s <= t
        gb = _einsum("btn,bsn->bts", cc, bc)                # (B,Q,Q)
        dl = torch.clamp(L[:, :, None, :] - L[:, None, :, :], -CLAMP, CLAMP)
        m = torch.exp(dl) * tri[None, :, :, None]           # (B,Q,Q,H)
        y_intra = _einsum("bts,btsh,bsh,bshp->bthp", gb, m, dtc, xc)
        # inter-chunk: exp(L_t) C_t . S_in
        y_inter = _einsum("bth,btn,bhpn->bthp", torch.exp(torch.clamp(L, -CLAMP, 0)), cc, s_in)
        # the state after the chunk
        decay_out = torch.exp(torch.clamp(Lq - L, -CLAMP, 0))     # (B,Q,H)
        s_in = (torch.exp(torch.clamp(Lq, -CLAMP, 0))[:, 0, :, None, None] * s_in
                + _einsum("bth,bth,bthp,btn->bhpn", decay_out, dtc, xc, bc))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    return y + d_skip[None, None, :, None] * xh, s_in


# ---------------------------------------------------------------------------
# WKV6 (RWKV-6 Finch), data-dependent per-channel decay
# ---------------------------------------------------------------------------

def wkv6_chunked(r, k, v, w, u, s0, *, chunk: int = 32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: (B,S,H,P) f32; w: (B,S,H,P) decay in (0,1]; u: (H,P);
    s0: (B,H,P,P). Matches `rwkv6._wkv_scan`: S_t = diag(w_t) S_{t-1} + k⊗v,
    y_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)."""
    s = r.shape[1]
    q = _chunk_len(s, chunk)
    lw = torch.log(torch.clamp(w, min=1e-38))               # (B,S,H,P) <= 0
    tri_lo = torch.tril(torch.ones((q, q), dtype=torch.float32, device=r.device),
                        diagonal=-1)                        # strictly causal
    s_in, ys = s0, []
    for rc, kc, vc, lwc in zip(*(_chunks(a, q) for a in (r, k, v, lw))):
        L = torch.cumsum(lwc, dim=1)                        # (B,Q,H,P)
        Lq = L[:, -1:]                                      # (B,1,H,P)
        # y_t intra = Σ_{s<t} Σ_p r_t[p] exp(L[t-1,p]-L[s,p]) k_s[p] v_s, with
        # exp(L[t-1]-L[s]) = exp(L[t]-lw[t]-L[s]) factorised around a
        # mid-chunk reference, so that each factor's exponent is bounded by
        # half a chunk's decay (strong-decay channels would otherwise
        # saturate the clamp and break the product identity)
        mid = L.shape[1] // 2
        Lref = L[:, mid:mid + 1].detach()
        r_sc = rc * torch.exp(torch.clamp(L - lwc - Lref, -CLAMP, CLAMP))
        k_sc = kc * torch.exp(torch.clamp(Lref - L, -CLAMP, CLAMP))
        scores = _einsum("bthp,bshp->bhts", r_sc, k_sc) * tri_lo[None, None]
        y_intra = _einsum("bhts,bshp->bthp", scores, vc)
        # diagonal u bonus: (r_t · u ⊙ k_t) v_t
        bonus = _einsum("bthp,hp,bthp->bth", rc, u, kc)
        y_diag = bonus[..., None] * vc
        # inter-chunk: y_t += r_t · diag(exp(L[t-1])) S_in
        r_in = rc * torch.exp(torch.clamp(L - lwc, -CLAMP, 0))
        y_inter = _einsum("bthp,bhpz->bthz", r_in, s_in)
        # S_out = diag(exp(Lq)) S_in + Σ_s diag(exp(Lq - L_s)) k_s ⊗ v_s
        k_out = kc * torch.exp(torch.clamp(Lq - L, -CLAMP, 0))
        s_in = (torch.exp(torch.clamp(Lq, -CLAMP, 0))[:, 0, :, :, None] * s_in
                + _einsum("bshp,bshz->bhpz", k_out, vc))
        ys.append(y_intra + y_diag + y_inter)
    return torch.cat(ys, dim=1), s_in


# ---------------------------------------------------------------------------
# GLA (gated linear attention), per-key-channel sigmoid gate
# ---------------------------------------------------------------------------

def gla_chunked(qh, k, v, a, s0, *, chunk: int = 32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v: (B,S,H,P) f32; a: (B,S,H,P) gate in (0,1]; s0: (B,H,P,P).
    Matches `gla._gla_scan`: S_t = diag(a_t) S_{t-1} + k⊗v, y_t = q_t · S_t
    (the current token's k⊗v enters undecayed: the inclusive-decay variant of
    the WKV6 form, with no u bonus)."""
    s = qh.shape[1]
    q = _chunk_len(s, chunk)
    la = torch.log(torch.clamp(a, min=1e-38))               # (B,S,H,P) <= 0
    tri = torch.tril(torch.ones((q, q), dtype=torch.float32, device=qh.device))
    s_in, ys = s0, []
    for qc, kc, vc, lac in zip(*(_chunks(x, q) for x in (qh, k, v, la))):
        L = torch.cumsum(lac, dim=1)                        # (B,Q,H,P) inclusive
        Lq = L[:, -1:]
        # y_t intra = Σ_{s<=t} Σ_p q_t[p] exp(L[t,p]-L[s,p]) k_s[p] v_s, around
        # a mid-chunk reference (see the WKV6 note)
        mid = L.shape[1] // 2
        Lref = L[:, mid:mid + 1].detach()
        q_sc = qc * torch.exp(torch.clamp(L - Lref, -CLAMP, CLAMP))
        k_sc = kc * torch.exp(torch.clamp(Lref - L, -CLAMP, CLAMP))
        scores = _einsum("bthp,bshp->bhts", q_sc, k_sc) * tri[None, None]
        y_intra = _einsum("bhts,bshp->bthp", scores, vc)
        # inter-chunk: y_t += q_t · diag(exp(L_t)) S_in
        q_in = qc * torch.exp(torch.clamp(L, -CLAMP, 0))
        y_inter = _einsum("bthp,bhpz->bthz", q_in, s_in)
        k_out = kc * torch.exp(torch.clamp(Lq - L, -CLAMP, 0))
        s_in = (torch.exp(torch.clamp(Lq, -CLAMP, 0))[:, 0, :, :, None] * s_in
                + _einsum("bshp,bshz->bhpz", k_out, vc))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), s_in
