"""RWKV-6 "Finch" (attention-free, data-dependent decay), arXiv:2404.05892.

Token-shift mixing, r/k/v/g projections, the Finch signature data-dependent
decay w_t = exp(-exp(w0 + tanh(x_w A) B)) through a low-rank adapter, and a
per-head WKV state S in (B, H, P, P) with the recurrence

    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    y_t = r_t · (S_{t-1} + diag(u) (k_t ⊗ v_t))

then a squared-ReLU channel mix. As in the JAX package the token-shift lerp
coefficients are static learned vectors. The projections (r/k/v/g/o and the
channel mix, 8 a layer) are LCD-clusterable and go through `layers.linear`
one at a time (on the card the LUT GEMV / GEMM); the decay LoRA, the shift
and the u bonus stay dense f32.

Parameters are stacked (L, ...) tensors under the JAX package's names; where
it scans over the layer axis, this module loops over layers in Python. The
full-sequence forward runs the chunked WKV form (`linear_attn.wkv6_chunked`)
when more than one token is fed; decode and serving run the exact sequential
recurrence. The static path's cache and the engine's slot state are updated
IN PLACE.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.distributed.sharding import on_parts, whole
from repro_torch.models import params as PT
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, rmsnorm, row_stable_matmul
from repro_torch.models.linear_attn import wkv6_chunked
from repro_torch.models.slot_state import (mask_slot_state, per_head_ranks, slot_serving_step,
                                           state_first, state_layer, token_by_token)
from repro_torch.models.transformer import layer_slice, remat_call

D = PT.ParamDecl
LORA = 64


def param_table(cfg: ModelConfig) -> PT.Table:
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, P = cfg.rwkv_heads, cfg.rwkv_head_dim
    ln = "layers,"
    return {
        "embed": D((cfg.padded_vocab, d), "vocab,embed", "embed"),
        "blocks": {
            "ln_tm": {"scale": D((L, d), ln + "embed_nofsdp", "zeros", "float32")},
            "ln_cm": {"scale": D((L, d), ln + "embed_nofsdp", "zeros", "float32")},
            "tm": {
                # static token-shift lerp coefficients per stream
                "mu_r": D((L, d), ln + "embed_nofsdp", "uniform:0.0~1.0"),
                "mu_k": D((L, d), ln + "embed_nofsdp", "uniform:0.0~1.0"),
                "mu_v": D((L, d), ln + "embed_nofsdp", "uniform:0.0~1.0"),
                "mu_g": D((L, d), ln + "embed_nofsdp", "uniform:0.0~1.0"),
                "mu_w": D((L, d), ln + "embed_nofsdp", "uniform:0.0~1.0"),
                "wr": D((L, d, d), ln + "embed,q_dim", "fanin"),
                "wk": D((L, d, d), ln + "embed,q_dim", "fanin"),
                "wv": D((L, d, d), ln + "embed,q_dim", "fanin"),
                "wg": D((L, d, d), ln + "embed,q_dim", "fanin"),
                "wo": D((L, d, d), ln + "q_dim,embed", "fanin"),
                # data-dependent decay LoRA: w0 + tanh(x A) B
                "w0": D((L, d), ln + "embed_nofsdp", "uniform:-7.0~-5.0", "float32"),
                "decay_A": D((L, d, LORA), ln + "embed_nofsdp,.", "fanin", "float32"),
                "decay_B": D((L, LORA, d), ln + ".,embed_nofsdp", "fanin:0.1", "float32"),
                "u": D((L, H, P), ln + "rwkv_heads,.", "normal:0.3", "float32"),
                "ln_out": {"scale": D((L, d), ln + "embed_nofsdp", "zeros", "float32")},
            },
            "cm": {
                "mu_k": D((L, d), ln + "embed_nofsdp", "uniform:0.0~1.0"),
                "mu_r": D((L, d), ln + "embed_nofsdp", "uniform:0.0~1.0"),
                "wk": D((L, d, f), ln + "embed,ff", "fanin"),
                "wv": D((L, f, d), ln + "ff,embed", "fanin"),
                "wr": D((L, d, d), ln + "embed,q_dim", "fanin"),
            },
        },
        "ln_final": {"scale": D((d,), "embed_nofsdp", "zeros", "float32")},
        "lm_head": D((d, cfg.padded_vocab), "embed,vocab", "fanin"),
    }


def _shift(x: torch.Tensor, x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: each position's previous token's features (zeros, or
    `x_prev` (B, d), before the first). x: (B, S, d)."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _lerp(x, z, mu):
    return x + (z - x) * mu.to(x.dtype)


def _wkv_scan(r, k, v, w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence, token by token. r/k/v: (B,S,H,P) f32; w:
    (B,S,H,P) decay in (0,1); u: (H,P); s0: (B,H,P,P). Returns (y (B,S,H,P),
    s_final). The output's sum over p is an elementwise product and a sum,
    not a batched product: cuBLAS's batched kernel gives a slot's row other
    bits at another slot count, the sum does not (H100)."""
    s, ys = s0, []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]      # (B,H,P)
        kv = kt[..., :, None] * vt[..., None, :]                  # outer product
        ys.append((rt[..., :, None] * (s + u[None, :, :, None] * kv)).sum(dim=-2))
        s = wt[..., None] * s + kv
    return torch.stack(ys, dim=1), s


def time_mix(p, x, cfg: ModelConfig, state) -> Tuple[torch.Tensor, Any]:
    """state = (S (B,H,P,P) f32, x_prev (B,d)), or None (the full sequence
    from a zero state). Returns (out, (S_new, x_last) or None).

    On a mesh each model rank runs the WKV recurrence over its heads (r, k,
    v, the decay and u in that rank's head slices), from its part of S
    (`Sharded` by heads, a serving mesh's) or its slice of the zero state
    (the full sequence on a training mesh's projections, cut by columns);
    every other op runs whole, on gathered values (`per_head_ranks`)."""
    b, s, d = x.shape
    H, P = cfg.rwkv_heads, cfg.rwkv_head_dim
    s0 = (state[0] if state is not None else
          torch.zeros((b, H, P, P), dtype=torch.float32, device=x.device))
    z = _shift(x, state[1] if state is not None else None)

    f32 = torch.float32
    r = linear(_lerp(x, z, p["mu_r"]), p["wr"])
    k = linear(_lerp(x, z, p["mu_k"]), p["wk"])
    v = linear(_lerp(x, z, p["mu_v"]), p["wv"])
    g = F.silu(whole(linear(_lerp(x, z, p["mu_g"]), p["wg"])))

    xw = _lerp(x, z, p["mu_w"]).to(f32)
    dlog = p["w0"] + row_stable_matmul(torch.tanh(row_stable_matmul(xw, p["decay_A"])),
                                       p["decay_B"])                   # (B,S,d)
    w = torch.exp(-torch.exp(dlog))                                  # data-dependent decay

    def wkv(r, k, v, w, u, s0):
        r, k, v, w = (a.reshape(b, s, -1, P).to(f32) for a in (r, k, v, w))
        if cfg.ssm_impl == "chunked" and s > 1:
            return wkv6_chunked(r, k, v, w, u, s0)
        with record_function("recurrent.scan"):
            return _wkv_scan(r, k, v, w, u, s0)

    y, s_new = per_head_ranks(wkv, s0, (r, k, v, w, p["u"]), (-1, -1, -1, -1, 0))
    # per-head group norm (an rms norm over the flattened head outputs)
    y = rmsnorm(y.reshape(b, s, d), p["ln_out"]["scale"])
    out = whole(linear(y * g.to(y.dtype), p["wo"])).to(x.dtype)
    return out, ((s_new, x[:, -1]) if state is not None else None)


def channel_mix(p, x, cfg: ModelConfig, x_prev) -> Tuple[torch.Tensor, Any]:
    z = _shift(x, x_prev)
    k = torch.square(F.relu(whole(linear(_lerp(x, z, p["mu_k"]), p["wk"]))))
    kv = whole(linear(k, p["wv"]))
    rgate = torch.sigmoid(whole(linear(_lerp(x, z, p["mu_r"]), p["wr"])))
    return rgate * kv, (x[:, -1] if x_prev is not None else None)


def _block(p, x, cfg: ModelConfig, wkv=None, x_tm=None, x_cm=None):
    """One layer: (x out, (S_new, x_tm_new, x_cm_new)); the state parts are
    None over a full sequence (wkv None)."""
    tm_state = (wkv, x_tm) if wkv is not None else None
    h, st = time_mix(p["tm"], rmsnorm(x, p["ln_tm"]["scale"]), cfg, tm_state)
    x = x + h
    h, cm_prev = channel_mix(p["cm"], rmsnorm(x, p["ln_cm"]["scale"]), cfg, x_cm)
    new = (st[0], st[1], cm_prev) if st is not None else None
    return x + h, new


def _head(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["ln_final"]["scale"])
    return x @ params["lm_head"].to(x.dtype)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward from a zero state: (logits (B, S, padded_vocab),
    a zero aux). Differentiable (no `torch.no_grad()`); with `cfg.remat` and
    autograd on, each layer runs under `torch.utils.checkpoint`
    (`transformer.remat_call`)."""
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(cfg.n_layers):
        p = layer_slice(params["blocks"], l)
        x = (remat_call(cfg, _block, p, x, cfg) if remat else _block(p, x, cfg))[0]
    return _head(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


# --- decode: constant-size recurrent state (the static path) ----------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> Dict[str, Any]:
    """The static path's cache: the stacked recurrent state of `batch`
    sequences (its size does not depend on `max_seq`) and `pos`, a 0-d int32
    tensor that `decode_step` advances in place."""
    c = init_slot_state(cfg, batch, max_seq, device)
    c["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return c


# the static path's cache's logical dim names (`launch/steps.py build_serve_step`)
CACHE_NAMES = {"wkv": "layers,batch,rwkv_heads,.,.", "x_tm": "layers,batch,.",
               "x_cm": "layers,batch,.", "pos": ""}


@torch.no_grad()
def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: ModelConfig):
    """One static-path step of the whole stack over `tokens` (B, S): returns
    the last token's logits (B, padded_vocab) and the cache, its state
    updated in place and its `pos` advanced by one, as the JAX package's
    is (the recurrence has no positions)."""
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]
    for l in range(cfg.n_layers):
        x, new = _block(layer_slice(params["blocks"], l), x, cfg,
                        cache["wkv"][l], cache["x_tm"][l], cache["x_cm"][l])
        for name, t in zip(SLOT_STATE_NAMES, new):
            cache[name][l].copy_(t)
    cache["pos"].fill_(pos + 1)
    return _head(params, x[:, -1:], cfg)[:, -1], cache


# --- serving: fixed-size per-slot state (launch/engine.py) --------------------

def init_slot_state(cfg: ModelConfig, num_slots: int, max_seq: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    H, P, d, L = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_model, cfg.n_layers
    return {
        "wkv": torch.zeros((L, num_slots, H, P, P), dtype=torch.float32, device=device),
        "x_tm": torch.zeros((L, num_slots, d), dtype=cfg.torch_dtype, device=device),
        "x_cm": torch.zeros((L, num_slots, d), dtype=cfg.torch_dtype, device=device),
    }


SLOT_STATE_NAMES = {"wkv": "layers,slots,rwkv_heads,.,.",
                    "x_tm": "layers,slots,.", "x_cm": "layers,slots,."}


def _state_step(params, state, tok: torch.Tensor, active: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """One token for every slot: tok (slots, 1). Each layer's new state rows
    replace the old ones in place where `active` (`mask_slot_state`, layer by
    layer: the same bits as masking the whole stack after the token, since a
    layer's state is read only by that layer). Returns the hidden rows before
    the final norm, (slots, 1, d)."""
    x = params["embed"].to(cfg.torch_dtype)[tok.long()]
    for l in range(cfg.n_layers):
        old = {name: state_layer(state[name], l) for name in SLOT_STATE_NAMES}
        x, new = _block(layer_slice(params["blocks"], l), x, cfg, state_first(old["wkv"]),
                        whole(old["x_tm"])[0], whole(old["x_cm"])[0])
        mask_slot_state({name: on_parts(t, lambda a: a[None])
                         for name, t in zip(SLOT_STATE_NAMES, new)}, old, active)
    return x


# The engine step over a (slots, T) window, one token at a time so that the
# exact sequential WKV recurrence runs (the chunked form needs more than one
# token and never runs here): (the logits at each slot's last valid token
# (slots, padded_vocab), `caches`, whose slot state was updated in place).
serving_step = slot_serving_step(token_by_token(_state_step), _head)
