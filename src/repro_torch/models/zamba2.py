"""Zamba2-style hybrid: a Mamba2 backbone and one shared attention block
(arXiv:2411.15242).

Mamba2 (SSD) block, single B/C group:
    [z, xc, B, C, dt] = x W_in ;  xc -> causal depthwise conv (width 4) -> silu
    per head h:  a_t = exp(-softplus(dt_t + dt_bias) * exp(A_log_h))
                 S_t = a_t S_{t-1} + dt_t * (x_t ⊗ B_t)        S in (B,H,P,N)
                 y_t = S_t · C_t + D_h * x_t
    out = (y * silu(z)) W_out

The shared transformer block (attention + SwiGLU MLP, one set of unstacked
weights) runs after every `attn_period` Mamba layers; each of its `n_sites`
application sites keeps its own KV cache. `w_in` and `w_out` are LCD-
clusterable (on the card the LUT GEMV / GEMM), and so are the shared block's
projections (QKV and gate+up as multi-projection launches); the SSM dynamics
(A_log, dt_bias, conv, D) stay dense f32.

The engine serves this family through BOTH cache protocols in one step: the
mamba ssm / conv state in a SlotStateCache, the shared sites' K / V in a
paged block pool driven by the engine's block tables, read by the paged
attention kernel. Where the JAX package scans over layers, this module loops
over them in Python; the static cache, the slot state and the pools are
updated IN PLACE.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.distributed.sharding import Sharded, on_parts, parts_on, rank_parts, whole
from repro_torch.kernels.ref import lane_stable
from repro_torch.models import params as PT
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attn_block, linear, mlp_block, paged_attn_block,
                                       rmsnorm)
from repro_torch.models.linear_attn import ssd_chunked
from repro_torch.models.slot_state import (gather_last_logits, mask_slot_state, per_head_ranks,
                                           slot_serving_step, state_first, state_layer)
from repro_torch.models.transformer import (_attn_table, _mlp_table, layer_slice,
                                            remat_call)

D = PT.ParamDecl


def _mamba_in_dim(cfg: ModelConfig) -> int:
    # [z (di), xc (di), B (N), C (N), dt (H)]
    return 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads


def param_table(cfg: ModelConfig) -> PT.Table:
    L, d = cfg.n_layers, cfg.d_model
    di, H = cfg.d_inner, cfg.ssm_heads
    ln = "layers,"
    return {
        "embed": D((cfg.padded_vocab, d), "vocab,embed", "embed"),
        "blocks": {
            "ln": {"scale": D((L, d), ln + "embed_nofsdp", "zeros", "float32")},
            "w_in": D((L, d, _mamba_in_dim(cfg)), ln + "embed,ssm_in", "fanin"),
            "conv": D((L, cfg.ssm_conv, di), ln + "conv,.", "normal:0.1", "float32"),
            "a_log": D((L, H), ln + "ssm_heads", "uniform:0.0~1.4", "float32"),
            "dt_bias": D((L, H), ln + "ssm_heads", "uniform:-4.6~-2.3", "float32"),
            "d_skip": D((L, H), ln + "ssm_heads", "ones", "float32"),
            "w_out": D((L, di, d), ln + "ssm_inner,embed", "fanin"),
        },
        # ONE shared attention + MLP block (unstacked), reused at every site
        "shared": {
            "ln_attn": {"scale": D((d,), "embed_nofsdp", "zeros", "float32")},
            "attn": _attn_table(cfg, stacked=False),
            "ln_mlp": {"scale": D((d,), "embed_nofsdp", "zeros", "float32")},
            "mlp": _mlp_table(cfg, stacked=False),
        },
        "ln_final": {"scale": D((d,), "embed_nofsdp", "zeros", "float32")},
        "lm_head": D((d, cfg.padded_vocab), "embed,vocab", "fanin"),
    }


def n_sites(cfg: ModelConfig) -> int:
    return max(cfg.n_layers // max(cfg.attn_period, 1), 1)


def _segments(cfg: ModelConfig):
    """(layer range, site or None) of the backbone in order: `n_sites`
    segments of `attn_period` layers, each followed by its site, then the
    trailing layers no site follows. A model shorter than its period has
    one site after all of its layers, as the JAX package's slices give."""
    per, sites = max(cfg.attn_period, 1), n_sites(cfg)
    segs = [(range(i * per, min((i + 1) * per, cfg.n_layers)), i) for i in range(sites)]
    if cfg.n_layers > sites * per:
        segs.append((range(sites * per, cfg.n_layers), None))
    return segs


def _causal_conv(xc: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv of width K. xc: (B,S,di); w: (K,di); state:
    (B,K-1,di), the trailing inputs before this call (decode), or None
    (zeros). Returns (out (B,S,di), the new trailing inputs). Elementwise:
    a slot's bits do not depend on the slot count."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xc.shape[0], k - 1, xc.shape[2]), dtype=xc.dtype, device=xc.device)
    else:
        pad = state.to(xc.dtype)
    xp = torch.cat([pad, xc], dim=1)                            # (B, S+K-1, di)
    out = sum(xp[:, i:i + xc.shape[1]] * w[i].to(xc.dtype) for i in range(k))
    return out, xp[:, -(k - 1):]


def _ssd_scan(xh, Bt, Ct, dt, a_log, d_skip, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence, token by token. xh: (B,S,H,P) f32; Bt/Ct:
    (B,S,N); dt: (B,S,H); s0: (B,H,P,N). The output's sum over n is an
    elementwise product and a sum, whose bits for a slot do not depend on
    the slot count (a batched product's do not hold that, H100)."""
    decay = lane_stable(torch.exp, -dt * lane_stable(torch.exp, a_log)[None, None, :])
    s, ys = s0, []
    for t in range(xh.shape[1]):
        x_t, b_t, c_t = xh[:, t], Bt[:, t], Ct[:, t]
        inject = (x_t * dt[:, t, :, None])[..., None] * b_t[:, None, None, :]
        s = decay[:, t, :, None, None] * s + inject
        ys.append((s * c_t[:, None, None, :]).sum(dim=-1))
    y = torch.stack(ys, dim=1) + d_skip[None, None, :, None] * xh
    return y, s


def mamba_block(p, x, cfg: ModelConfig, state) -> Tuple[torch.Tensor, Any]:
    """state = (ssm (B,H,P,N) f32, conv (B,K-1,di)), or None (the full
    sequence from a zero state). Returns (out, (ssm_new, conv_new) or None)."""
    b, s, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcd = whole(linear(x, p["w_in"]))
    z, xc, Bt, Ct, dt = torch.split(zxbcd, [di, di, N, N, H], dim=-1)
    # on a mesh each model rank runs the conv over its inner channels and
    # the recurrence over its heads, from its part of the state (`Sharded`
    # by channels / heads when serving) or its slice of the zero state (the
    # full sequence), every other op whole; xc is cut as a_log is, so that a
    # rank's channels are its heads'
    ranks = rank_parts(p["a_log"])
    if len(ranks) > 1:
        xc = Sharded(tuple(parts_on(xc, len(ranks), -1)), -1)
    xc, conv_state = per_head_ranks(_causal_conv, state[1] if state is not None else None,
                                    (xc, p["conv"]), (-1, -1), out_dim=-1, state_dim=-1)
    xc = F.silu(xc)
    f32 = torch.float32
    dtf = lane_stable(F.softplus, dt.to(f32) + whole(p["dt_bias"])[None, None])
    s0 = (state[0] if state is not None else
          torch.zeros((b, H, P, N), dtype=f32, device=x.device))
    Bt, Ct = Bt.to(f32), Ct.to(f32)

    def ssd(xh, dt, a_log, d_skip, s0):
        xh = xh.reshape(b, s, -1, P).to(f32)
        if cfg.ssm_impl == "chunked" and s > 1:
            # block-parallel SSD: the state is materialised once per chunk
            return ssd_chunked(xh, Bt, Ct, dt, a_log, d_skip, s0)
        with record_function("recurrent.scan"):
            return _ssd_scan(xh, Bt, Ct, dt, a_log, d_skip, s0)

    y, s_new = per_head_ranks(ssd, s0, (xc, dtf, p["a_log"], p["d_skip"]), (-1,) * 4)
    y = y.reshape(b, s, di).to(x.dtype) * F.silu(z)
    out = whole(linear(y, p["w_out"]))
    return out, ((s_new, conv_state) if state is not None else None)


def _mamba_layer(p, x, cfg: ModelConfig, state=None):
    h, st = mamba_block(p, rmsnorm(x, p["ln"]["scale"]), cfg, state)
    return x + h, st


def _shared_attn(params, x, cfg: ModelConfig, cache=None, pos_offset=0) -> torch.Tensor:
    """The shared block at one site over a contiguous cache (its K / V
    written in place at cache["pos"]) or none (the full sequence)."""
    p = params["shared"]
    h = rmsnorm(x, p["ln_attn"]["scale"])
    x = x + attn_block(p["attn"], h, cfg, cache=cache, pos_offset=pos_offset)
    h = rmsnorm(x, p["ln_mlp"]["scale"])
    return x + mlp_block(p["mlp"], h, cfg)


def _head(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["ln_final"]["scale"])
    return x @ params["lm_head"].to(x.dtype)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits (B, S, padded_vocab), a zero aux).
    Differentiable; with `cfg.remat` and autograd on, each mamba layer runs
    under `transformer.remat_call`, as the JAX package checkpoints its
    scanned mamba body (the shared block is not checkpointed there either)."""
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]
    remat = cfg.remat and torch.is_grad_enabled()
    for layers, site in _segments(cfg):
        for l in layers:
            p = layer_slice(params["blocks"], l)
            x = (remat_call(cfg, _mamba_layer, p, x, cfg) if remat
                 else _mamba_layer(p, x, cfg))[0]
        if site is not None:
            x = _shared_attn(params, x, cfg)
    return _head(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


# --- decode over a contiguous cache (the static path) -----------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> Dict[str, Any]:
    """The static path's cache: the mamba state of `batch` sequences, each
    site's contiguous (sites, B, max_seq, KV, D) K / V, and `pos`, a 0-d
    int32 tensor that `decode_step` advances in place."""
    c = init_slot_state(cfg, batch, max_seq, device)
    kv = (n_sites(cfg), batch, max_seq, cfg.n_kv_heads, cfg.hd)
    c["k"] = torch.zeros(kv, dtype=cfg.torch_dtype, device=device)
    c["v"] = torch.zeros(kv, dtype=cfg.torch_dtype, device=device)
    c["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return c


# the static path's cache's logical dim names (`launch/steps.py build_serve_step`)
CACHE_NAMES = {
    "ssm": "layers,batch,ssm_heads,.,.",
    "conv": "layers,batch,.,ssm_inner",
    "k": "layers,batch,seq_kv,kv,.",
    "v": "layers,batch,seq_kv,kv,.",
    "pos": "",
}


@torch.no_grad()
def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: ModelConfig):
    """One static-path step over `tokens` (B, S) at positions pos..pos+S-1
    (the sites' K / V written there): the last token's logits and the
    cache, updated in place, its `pos` advanced by one as the JAX package's
    is (so a prompt of S > 1 tokens is followed by an explicit `pos`)."""
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]
    for layers, site in _segments(cfg):
        for l in layers:
            x, (ssm, conv) = _mamba_layer(layer_slice(params["blocks"], l), x, cfg,
                                          (cache["ssm"][l], cache["conv"][l]))
            cache["ssm"][l].copy_(ssm)
            cache["conv"][l].copy_(conv)
        if site is not None:
            x = _shared_attn(params, x, cfg, cache={"k": cache["k"][site],
                                                    "v": cache["v"][site], "pos": pos})
    cache["pos"].fill_(pos + 1)
    return _head(params, x[:, -1:], cfg)[:, -1], cache


# --- serving: both cache protocols through one step (launch/engine.py) -------

def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     kv_dtype: Optional[str] = None, device="cuda") -> Dict[str, torch.Tensor]:
    """Each site's K / V block pool, (sites, num_blocks, block_size, KV, D)
    in the model dtype. Float only: the hybrid has no int8_kv capability."""
    if kv_dtype not in (None, "float"):
        raise ValueError(
            f"hybrid paged pool supports kv_dtype='float' only, got {kv_dtype!r}"
            " (no int8_kv capability)")
    shape = (n_sites(cfg), num_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


PAGED_CACHE_NAMES = {"k": "sites,blocks,.,kv,.", "v": "sites,blocks,.,kv,."}


def init_slot_state(cfg: ModelConfig, num_slots: int, max_seq: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    L, di, K = cfg.n_layers, cfg.d_inner, cfg.ssm_conv
    return {
        "ssm": torch.zeros((L, num_slots, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((L, num_slots, K - 1, di), dtype=cfg.torch_dtype, device=device),
    }


SLOT_STATE_NAMES = {"ssm": "layers,slots,ssm_heads,.,.",
                    "conv": "layers,slots,.,ssm_inner"}


def _serving_trunk(params, caches, tokens, lengths, n_new, block_tables, cfg: ModelConfig):
    """The engine step's token passes over a (slots, T) window, one token at
    a time: the mamba layers run the exact sequential SSD recurrence on the
    slot state (each layer's rows masked in place where the token is valid),
    and the shared sites read and write their paged pools through the block
    tables at width 1 (the t-th valid token lands at lengths + t; a token
    past a slot's n_new writes nothing); on a mesh the sites' pools are cut
    on kv heads, B5 on each rank's. Returns each slot's hidden row (before
    the final norm) at its last valid token, (slots, d)."""
    state, pool = caches["slot"], caches["paged"]
    shared = params["shared"]
    xs = []
    for t in range(tokens.shape[1]):
        active = t < n_new
        x = params["embed"].to(cfg.torch_dtype)[tokens[:, t:t + 1].long()]
        for layers, site in _segments(cfg):
            for l in layers:
                old = {"ssm": state_layer(state["ssm"], l), "conv": state_layer(state["conv"], l)}
                x, (ssm, conv) = _mamba_layer(layer_slice(params["blocks"], l), x, cfg,
                                              (state_first(old["ssm"]), state_first(old["conv"])))
                mask_slot_state({"ssm": on_parts(ssm, lambda a: a[None]),
                                 "conv": on_parts(conv, lambda a: a[None])}, old, active)
            if site is None:
                continue
            h = rmsnorm(x, shared["ln_attn"]["scale"])
            x = x + paged_attn_block(
                shared["attn"], h, cfg, layer_window=0, kc=layer_slice(pool["k"], site),
                vc=layer_slice(pool["v"], site), block_tables=block_tables,
                lengths=lengths + t, n_new=active.to(lengths.dtype))
            h = rmsnorm(x, shared["ln_mlp"]["scale"])
            x = x + mlp_block(shared["mlp"], h, cfg)
        xs.append(x[:, 0])
    return gather_last_logits(torch.stack(xs), n_new)


# The engine step: (the logits at each slot's last valid token, `caches`,
# updated in place).
serving_step = slot_serving_step(_serving_trunk, _head)
