"""GLA: gated linear attention with a data-dependent forget gate,
arXiv:2312.06635.

Linear attention with a per-key-channel sigmoid forget gate driven by a
low-rank adapter:

    a_t = sigmoid(g0 + x_t A B)^{1/tau}          (gate, in (0,1))
    S_t = diag(a_t) S_{t-1} + k_t ⊗ v_t          (per-head state, (B,H,P,P))
    y_t = q_t · S_t

The q/k/v/o projections and the GELU MLP are LCD-clusterable and go through
`layers.linear` one at a time, as the JAX package calls them: q, k and v
are NOT grouped into one multi-projection launch. The gate adapter stays
dense f32 (it feeds sigmoid / pow). Unlike rwkv6, the current token's k⊗v
enters the output through S_t undecayed (inclusive decay, no u bonus), and
there is no token shift.

Parameters are stacked (L, ...) tensors under the JAX package's names; where
it scans over the layer axis, this module loops over layers in Python. The
full-sequence forward runs the chunked form (`linear_attn.gla_chunked`) when
more than one token is fed; decode and serving run the exact sequential
recurrence, updating the static cache and the slot state IN PLACE.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.distributed.sharding import on_parts, whole
from repro_torch.models import params as PT
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, rmsnorm, row_stable_matmul
from repro_torch.models.linear_attn import gla_chunked
from repro_torch.models.slot_state import (mask_slot_state, per_head_ranks, slot_serving_step,
                                           state_first, state_layer, token_by_token)
from repro_torch.models.transformer import layer_slice, remat_call

D = PT.ParamDecl
LORA = 64
TAU = 16.0   # gate temperature: a = sigmoid(.)^{1/tau} keeps the decay near 1


def param_table(cfg: ModelConfig) -> PT.Table:
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    ln = "layers,"
    return {
        "embed": D((cfg.padded_vocab, d), "vocab,embed", "embed"),
        "blocks": {
            "ln_attn": {"scale": D((L, d), ln + "embed_nofsdp", "zeros", "float32")},
            "ln_mlp": {"scale": D((L, d), ln + "embed_nofsdp", "zeros", "float32")},
            "attn": {
                "wq": D((L, d, d), ln + "embed,q_dim", "fanin"),
                "wk": D((L, d, d), ln + "embed,q_dim", "fanin"),
                "wv": D((L, d, d), ln + "embed,q_dim", "fanin"),
                "wo": D((L, d, d), ln + "q_dim,embed", "fanin"),
                # forget-gate LoRA: sigmoid(g0 + x A B)^{1/tau}
                "g0": D((L, d), ln + "embed_nofsdp", "uniform:2.0~6.0", "float32"),
                "gate_A": D((L, d, LORA), ln + "embed_nofsdp,.", "fanin", "float32"),
                "gate_B": D((L, LORA, d), ln + ".,embed_nofsdp", "fanin:0.1", "float32"),
                "ln_out": {"scale": D((L, d), ln + "embed_nofsdp", "zeros", "float32")},
            },
            "mlp": {
                "w_up": D((L, d, f), ln + "embed,ff", "fanin"),
                "w_down": D((L, f, d), ln + "ff,embed", "fanin"),
            },
        },
        "ln_final": {"scale": D((d,), "embed_nofsdp", "zeros", "float32")},
        "lm_head": D((d, cfg.padded_vocab), "embed,vocab", "fanin"),
    }


def _gla_scan(q, k, v, a, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence. q/k/v/a: (B,S,H,P) f32; s0: (B,H,P,P).
    Returns (y (B,S,H,P), s_final). The output's sum over p is an
    elementwise product and a sum, whose bits for a slot do not depend on
    the slot count (see `rwkv6._wkv_scan`)."""
    s, ys = s0, []
    for t in range(q.shape[1]):
        qt, kt, vt, at = q[:, t], k[:, t], v[:, t], a[:, t]      # (B,H,P)
        s = at[..., None] * s + kt[..., :, None] * vt[..., None, :]
        ys.append((qt[..., :, None] * s).sum(dim=-2))
    return torch.stack(ys, dim=1), s


def _gate(p, x: torch.Tensor) -> torch.Tensor:
    """a = sigmoid(g0 + tanh(x A) B)^{1/tau}, in f32. `gate_A` / `gate_B`
    must be dense: a clustered one raises TypeError at the product, as the
    JAX package's `xg @ p["gate_A"]` does (ROADMAP C)."""
    xg = x.to(torch.float32)
    glog = p["g0"] + row_stable_matmul(torch.tanh(row_stable_matmul(xg, p["gate_A"])),
                                       p["gate_B"])
    return torch.sigmoid(glog) ** (1.0 / TAU)


def gla_mix(p, x, cfg: ModelConfig, state) -> Tuple[torch.Tensor, Any]:
    """state = S (B,H,P,P) f32, or None (the full sequence from a zero
    state). Returns (out, S_new or None)."""
    b, s, d = x.shape
    H, P = cfg.rwkv_heads, cfg.rwkv_head_dim
    s0 = (state if state is not None else
          torch.zeros((b, H, P, P), dtype=torch.float32, device=x.device))
    f32 = torch.float32
    q = linear(x, p["wq"])
    k = linear(x, p["wk"])
    v = linear(x, p["wv"])
    a = _gate(p, x)

    # on a mesh each model rank's recurrence runs over its heads, from its
    # part of S or its slice of the zero state, every other op whole (see
    # `rwkv6.time_mix`)
    def mix(q, k, v, a, s0):
        q, k, v, a = (t.reshape(b, s, -1, P).to(f32) for t in (q, k, v, a))
        if cfg.ssm_impl == "chunked" and s > 1:
            return gla_chunked(q, k, v, a, s0)
        with record_function("recurrent.scan"):
            return _gla_scan(q, k, v, a, s0)

    y, s_new = per_head_ranks(mix, s0, (q, k, v, a), (-1, -1, -1, -1))
    y = rmsnorm(y.reshape(b, s, d), p["ln_out"]["scale"])
    out = whole(linear(y, p["wo"])).to(x.dtype)
    return out, (s_new if state is not None else None)


def _mlp(p, x):
    h = F.gelu(whole(linear(x, p["w_up"])), approximate="tanh")
    return whole(linear(h, p["w_down"]))


def _block(p, x, cfg: ModelConfig, s=None):
    """One layer: (x out, S_new or None)."""
    h, s = gla_mix(p["attn"], rmsnorm(x, p["ln_attn"]["scale"]), cfg, s)
    x = x + h
    return x + _mlp(p["mlp"], rmsnorm(x, p["ln_mlp"]["scale"])), s


def _head(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["ln_final"]["scale"])
    return x @ params["lm_head"].to(x.dtype)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward from a zero state: (logits (B, S, padded_vocab),
    a zero aux). Differentiable; with `cfg.remat` and autograd on, each
    layer runs under `transformer.remat_call`."""
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(cfg.n_layers):
        p = layer_slice(params["blocks"], l)
        x = (remat_call(cfg, _block, p, x, cfg) if remat else _block(p, x, cfg))[0]
    return _head(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


# --- decode: constant-size recurrent state (the static path) ----------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> Dict[str, Any]:
    """The static path's cache: the stacked state of `batch` sequences and
    `pos`, a 0-d int32 tensor that `decode_step` advances in place."""
    c = init_slot_state(cfg, batch, max_seq, device)
    c["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return c


# the static path's cache's logical dim names (`launch/steps.py build_serve_step`)
CACHE_NAMES = {"s": "layers,batch,rwkv_heads,.,.", "pos": ""}


@torch.no_grad()
def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: ModelConfig):
    """One static-path step over `tokens` (B, S): the last token's logits
    and the cache, its state updated in place and its `pos` advanced by one,
    as the JAX package's is."""
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]
    for l in range(cfg.n_layers):
        x, s = _block(layer_slice(params["blocks"], l), x, cfg, cache["s"][l])
        cache["s"][l].copy_(s)
    cache["pos"].fill_(pos + 1)
    return _head(params, x[:, -1:], cfg)[:, -1], cache


# --- serving: fixed-size per-slot state (launch/engine.py) --------------------

def init_slot_state(cfg: ModelConfig, num_slots: int, max_seq: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    H, P, L = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.n_layers
    return {"s": torch.zeros((L, num_slots, H, P, P), dtype=torch.float32, device=device)}


SLOT_STATE_NAMES = {"s": "layers,slots,rwkv_heads,.,."}


def _state_step(params, state, tok: torch.Tensor, active: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """One token for every slot, each layer's state masked in place where
    `active` (see `rwkv6._state_step`). Returns the hidden rows before the
    final norm, (slots, 1, d)."""
    x = params["embed"].to(cfg.torch_dtype)[tok.long()]
    for l in range(cfg.n_layers):
        old = state_layer(state["s"], l)
        x, s = _block(layer_slice(params["blocks"], l), x, cfg, state_first(old))
        mask_slot_state({"s": on_parts(s, lambda a: a[None])}, {"s": old}, active)
    return x


# The engine step over a (slots, T) window, one token at a time (the exact
# sequential recurrence; see `rwkv6.serving_step`).
serving_step = slot_serving_step(token_by_token(_state_step), _head)
