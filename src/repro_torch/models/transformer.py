"""Dense decoder-only transformer family — the paged serving path of the
continuous-batching engine and the contiguous-cache decode of the static path.

Covers llama2-7b (the paper's own subject), qwen2-1.5b (GQA, QKV bias,
padded heads), gemma2-27b (alternating local/global windows, attention and
final softcaps), starcoder2-15b (layernorm, the gelu MLP with biases, QKV
bias), stablelm-12b (layernorm, head_dim 160) and paligemma-3b's text decoder
(16-into-1 GQA over padded heads, head_dim 256). Parameters are stacked
(L, ...) tensors under the JAX package's names (`embed`,
`blocks/{ln_attn,attn,ln_mlp,mlp}`, `ln_final`, `lm_head`), so
carrying weights across is a rename-free copy; where the JAX package scans
over the layer axis, this module loops over layers in Python and indexes the
stacked tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import is_clustered, map_arrays
from repro_torch.models import params as PT
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attn_block, mlp_block, norm,
                                       paged_attn_block)

D = PT.ParamDecl


# ---------------------------------------------------------------------------
# Parameter table
# ---------------------------------------------------------------------------

def _norm_decl(cfg: ModelConfig, stacked: bool = True) -> Dict[str, D]:
    lead = (cfg.n_layers,) if stacked else ()
    names = "layers," if stacked else ""
    t = {"scale": D(lead + (cfg.d_model,), names + "embed_nofsdp", "zeros", "float32")}
    if cfg.norm == "layernorm":
        t["scale"] = D(lead + (cfg.d_model,), names + "embed_nofsdp", "ones", "float32")
        t["bias"] = D(lead + (cfg.d_model,), names + "embed_nofsdp", "zeros", "float32")
    return t


def _attn_table(cfg: ModelConfig) -> Dict[str, D]:
    L = (cfg.n_layers,)
    d, qd, kvd = cfg.d_model, cfg.q_dim_eff, cfg.kv_dim
    t = {
        "wq": D(L + (d, qd), "layers,embed,q_dim", "fanin"),
        "wk": D(L + (d, kvd), "layers,embed,kv_flat", "fanin"),
        "wv": D(L + (d, kvd), "layers,embed,kv_flat", "fanin"),
        "wo": D(L + (qd, d), "layers,q_dim,embed", "fanin"),
    }
    if cfg.qkv_bias:
        t["bq"] = D(L + (qd,), "layers,q_dim", "zeros")
        t["bk"] = D(L + (kvd,), "layers,kv_flat", "zeros")
        t["bv"] = D(L + (kvd,), "layers,kv_flat", "zeros")
    return t


def _mlp_table(cfg: ModelConfig) -> Dict[str, D]:
    L = (cfg.n_layers,)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.n_experts:
        raise NotImplementedError(
            "mixture-of-experts MLPs (moe_block) are not ported yet")
    if cfg.mlp == "swiglu":
        return {
            "w_gate": D(L + (d, f), "layers,embed,ff", "fanin"),
            "w_up": D(L + (d, f), "layers,embed,ff", "fanin"),
            "w_down": D(L + (f, d), "layers,ff,embed", "fanin"),
        }
    return {
        "w_up": D(L + (d, f), "layers,embed,ff", "fanin"),
        "b_up": D(L + (f,), "layers,ff", "zeros"),
        "w_down": D(L + (f, d), "layers,ff,embed", "fanin"),
        "b_down": D(L + (d,), "layers,embed_nofsdp", "zeros"),
    }


def param_table(cfg: ModelConfig) -> PT.Table:
    t: PT.Table = {
        "embed": D((cfg.padded_vocab, cfg.d_model), "vocab,embed", "embed"),
        "blocks": {
            "ln_attn": _norm_decl(cfg),
            "attn": _attn_table(cfg),
            "ln_mlp": _norm_decl(cfg),
            "mlp": _mlp_table(cfg),
        },
        "ln_final": _norm_decl(cfg, stacked=False),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = D((cfg.d_model, cfg.padded_vocab), "embed,vocab", "fanin")
    return t


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding-window sizes (0 = global), on the host."""
    if cfg.layer_pattern == "alt_local_global" and cfg.local_window:
        w = np.zeros(cfg.n_layers, np.int32)
        w[0::2] = cfg.local_window      # even layers local, odd global (gemma2)
        return w
    return np.zeros(cfg.n_layers, np.int32)


def lm_head_logits(params: Dict[str, Any], x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Vocab projection (tied or untied) + optional final softcap.
    `x` is (..., d_model)."""
    head = params.get("lm_head", None)
    logits = (x @ head.to(x.dtype)) if head is not None else (
        x @ params["embed"].to(x.dtype).T)
    if cfg.final_softcap:
        logits = (cfg.final_softcap * torch.tanh(
            logits.to(torch.float32) / cfg.final_softcap)).to(logits.dtype)
    return logits


def layer_slice(tree: Any, l: int) -> Any:
    """Layer `l` of a tree of stacked (L, ...) tensors: every tensor — and
    every array field of a ClusteredTensor — indexed on its leading axis.
    The slices are views; nothing is copied."""
    if is_clustered(tree):
        return map_arrays(tree, lambda a: a[l])
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    return tree[l]


# ---------------------------------------------------------------------------
# Decode over a contiguous (L, B, S, KV, D) cache (static-batch path)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, Any]:
    """The static path's cache: stacked (L, B, max_seq, KV, D) K and V in the
    model dtype, or int8 codes with (L, B, max_seq, KV) f32 scales when
    cfg.kv_cache_dtype is "int8"; `pos`, the number of cached positions, is
    a 0-d int32 tensor on `device`, as in the JAX package, which `decode_step`
    advances in place."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    int8 = cfg.kv_cache_dtype == "int8"
    dt = torch.int8 if int8 else cfg.torch_dtype
    c: Dict[str, Any] = {"k": torch.zeros(shape, dtype=dt, device=device),
                         "v": torch.zeros(shape, dtype=dt, device=device),
                         "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if int8:
        sshape = shape[:-1]
        c["k_scale"] = torch.full(sshape, 1e-6, dtype=torch.float32, device=device)
        c["v_scale"] = torch.full(sshape, 1e-6, dtype=torch.float32, device=device)
    return c


def _block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor, window: int,
           cache: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    h = norm(x, p["ln_attn"], cfg.norm)
    x = x + attn_block(p["attn"], h, cfg, layer_window=window, cache=cache)
    h = norm(x, p["ln_mlp"], cfg.norm)
    return x + mlp_block(p["mlp"], h, cfg)


@torch.no_grad()
def decode_step(
    params: Dict[str, Any],
    cache: Dict[str, Any],
    tokens: torch.Tensor,             # (B, S) — S=1 decode, S=prompt_len prefill
    pos,                              # cached positions so far: 0-d int32 tensor or int
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One step of the whole stack over the contiguous cache: the S new
    tokens are embedded, attended and written at positions pos..pos+S-1.
    Returns the logits of the LAST token (B, padded_vocab) and the cache,
    whose tensors were updated in place and whose `pos` tensor now holds
    pos + S. `pos` is read on the device only (normally it is `cache["pos"]`
    itself), so one captured step replays at any position. Where the JAX
    package scans over the layer axis, this loops over layers in Python."""
    if cfg.n_experts:
        raise NotImplementedError(
            "mixture-of-experts MLPs (moe_block) are not ported yet")
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]     # (B, S, d)
    windows = layer_windows(cfg)
    blocks = params["blocks"]
    for l in range(cfg.n_layers):
        lcache = {name: t[l] for name, t in cache.items() if name != "pos"}
        lcache["pos"] = pos
        x = _block(cfg, layer_slice(blocks, l), x, int(windows[l]), cache=lcache)
    x = norm(x[:, -1], params["ln_final"], cfg.norm)
    cache["pos"].fill_(pos + tokens.shape[-1])
    return lm_head_logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Paged decode (continuous-batching serving engine)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     kv_dtype: Optional[str] = None,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Block-pool KV cache: physical blocks are owned by the engine's
    free-list allocator (launch/engine.py); the model only sees per-step block
    tables, and per-slot lengths live with the scheduler, not the cache.

    kv_dtype "float" stores blocks in the model dtype; "int8" stores int8
    codes plus per-(block-slot, kv-head) scale pools and per-(layer, kv-head,
    channel) smoothing vectors (identity until the engine installs calibrated
    ones). None resolves from cfg.kv_cache_dtype."""
    if kv_dtype is None:
        kv_dtype = "int8" if cfg.kv_cache_dtype == "int8" else "float"
    if kv_dtype not in ("float", "int8"):
        raise ValueError(f"kv_dtype must be 'float' or 'int8'; got {kv_dtype!r}")
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    if kv_dtype != "int8":
        return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
    sshape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads)
    smshape = (cfg.n_layers, cfg.n_kv_heads, cfg.hd)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.full(sshape, 1e-6, **f32),
        "v_scale": torch.full(sshape, 1e-6, **f32),
        "k_smooth": torch.ones(smshape, **f32),
        "v_smooth": torch.ones(smshape, **f32),
    }


def _paged_trunk(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],   # {"k","v"}: (L, num_blocks, block_size, KV, D)
    tokens: torch.Tensor,             # (S_slots, T) — T-token window per slot
    lengths: torch.Tensor,            # (S_slots,) tokens already cached per slot
    n_new: torch.Tensor,              # (S_slots,) valid tokens among the T fed
    block_tables: torch.Tensor,       # (S_slots, max_blocks) int32
    cfg: ModelConfig,
) -> torch.Tensor:
    """Embed + layer loop over the paged KV cache. Returns the final-norm
    hidden states (S, T, d); the block pools in `cache` are updated in place.
    Whether the cache is quantized is decided by the pool dtype. Nothing in
    the loop reads a value back to the host: the per-layer window is a Python
    int and every ragged quantity is a mask."""
    if cfg.n_experts:
        raise NotImplementedError(
            "mixture-of-experts MLPs (moe_block) are not ported yet")
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]     # (S, T, d)
    windows = layer_windows(cfg)
    int8_kv = cache["k"].dtype == torch.int8
    blocks = params["blocks"]

    for l in range(cfg.n_layers):
        p = layer_slice(blocks, l)
        kv_kw = dict(kc=cache["k"][l], vc=cache["v"][l])
        if int8_kv:
            kv_kw.update(kc_scale=cache["k_scale"][l], vc_scale=cache["v_scale"][l],
                         k_smooth=cache["k_smooth"][l], v_smooth=cache["v_smooth"][l])
        h = norm(x, p["ln_attn"], cfg.norm)
        x = x + paged_attn_block(
            p["attn"], h, cfg, layer_window=int(windows[l]),
            block_tables=block_tables, lengths=lengths, n_new=n_new, **kv_kw)
        h = norm(x, p["ln_mlp"], cfg.norm)
        x = x + mlp_block(p["mlp"], h, cfg)

    return norm(x, params["ln_final"], cfg.norm)


@torch.no_grad()
def paged_decode_step(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,             # (S_slots, T) int32
    lengths: torch.Tensor,            # (S_slots,) int32
    n_new: torch.Tensor,              # (S_slots,) int32
    block_tables: torch.Tensor,       # (S_slots, max_blocks) int32
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One interleaved prefill/decode step for every slot.

    The same computation serves prefilling, decoding and idle slots at once:
    per-slot position/length/activity are data (masks), so the engine runs
    exactly one step shape per token-window width T. Returns the logits of
    each slot's LAST valid token (its next-token distribution) and `cache`,
    whose pools were updated in place."""
    x = _paged_trunk(params, cache, tokens, lengths, n_new, block_tables, cfg)
    # lm_head only at each slot's last valid token — the padded tail of a
    # prefill chunk never reaches the vocab matmul
    last_idx = torch.clamp(n_new - 1, min=0).long()
    last = x[torch.arange(x.shape[0], device=x.device), last_idx]      # (S, d)
    return lm_head_logits(params, last, cfg), cache


@torch.no_grad()
def paged_verify_step(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,             # (S_slots, T) int32 — T = speculative_k + 1
    lengths: torch.Tensor,            # (S_slots,) int32
    n_new: torch.Tensor,              # (S_slots,) int32
    block_tables: torch.Tensor,       # (S_slots, max_blocks) int32
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multi-token verification step for speculative decoding.

    The trunk of `paged_decode_step` — the same writes through the block
    tables, the same masks — with the vocab head applied at EVERY window
    position, so one step yields the target's next-token choice after each
    of the k+1 fed tokens (the pending token and k drafts). The engine
    accepts the longest matching draft prefix and rolls the rest back by not
    advancing `lengths` past it: entries beyond `lengths` are unobservable
    (reads are masked by `lengths + n_new`, writes land at `lengths + t`), so
    stale K/V of rejected tokens is overwritten by the next round.

    Greedy speculative output equals plain greedy output only if a
    position's logits are the bits a width-1 step computes for it: every op
    here gives a row the same bits at S (k+1) rows as at S (the LUT kernels'
    row contract, B5's per-row key order, the norms' statistics
    (`layers._stat_rows`), the head's one product; `chip_smoke.py` checks
    them on the card). Returns ((S, T, padded_vocab) logits, `cache`, whose
    pools were updated in place)."""
    x = _paged_trunk(params, cache, tokens, lengths, n_new, block_tables, cfg)
    return lm_head_logits(params, x, cfg), cache
