"""Dense / MoE decoder-only transformer family — the full-sequence forward
(train, prefill, evaluation), the paged serving path of the
continuous-batching engine and the contiguous-cache decode of the static
path.

Covers llama2-7b (the paper's own subject), qwen2-1.5b (GQA, QKV bias,
padded heads), gemma2-27b (alternating local/global windows, attention and
final softcaps), starcoder2-15b (layernorm, the gelu MLP with biases, QKV
bias), stablelm-12b (layernorm, head_dim 160), paligemma-3b's text decoder
(16-into-1 GQA over padded heads, head_dim 256), and the MoE archs
phi3.5-moe-42b-a6.6b (16 experts, top-2) and llama4-scout-17b-a16e (16
experts, top-1, padded heads), whose MLP is `layers.moe_block` over stacked
(L, E, d, f) expert weights and an (L, d, E) router. Parameters are stacked
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
from repro_torch.distributed.collectives import all_gather, exchange_rows, is_process_mesh
from repro_torch.distributed.placement import MeshTree, data_rows
from repro_torch.distributed.sharding import Sharded, maybe_shard, use_rules
from repro_torch.models import params as PT
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attn_block, mlp_block, moe_block, norm,
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


def _attn_table(cfg: ModelConfig, stacked: bool = True) -> Dict[str, D]:
    """The attention's weights, stacked (L, ...) or, for zamba2's one shared
    block, unstacked."""
    L = (cfg.n_layers,) if stacked else ()
    ln = "layers," if stacked else ""
    d, qd, kvd = cfg.d_model, cfg.q_dim_eff, cfg.kv_dim
    t = {
        "wq": D(L + (d, qd), f"{ln}embed,q_dim", "fanin"),
        "wk": D(L + (d, kvd), f"{ln}embed,kv_flat", "fanin"),
        "wv": D(L + (d, kvd), f"{ln}embed,kv_flat", "fanin"),
        "wo": D(L + (qd, d), f"{ln}q_dim,embed", "fanin"),
    }
    if cfg.qkv_bias:
        t["bq"] = D(L + (qd,), f"{ln}q_dim", "zeros")
        t["bk"] = D(L + (kvd,), f"{ln}kv_flat", "zeros")
        t["bv"] = D(L + (kvd,), f"{ln}kv_flat", "zeros")
    return t


def _mlp_table(cfg: ModelConfig, stacked: bool = True) -> Dict[str, D]:
    L = (cfg.n_layers,) if stacked else ()
    ln = "layers," if stacked else ""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.n_experts:
        e = cfg.n_experts
        return {
            "router": D(L + (d, e), f"{ln}embed_nofsdp,.", "fanin"),
            "w_gate": D(L + (e, d, f), f"{ln}experts,embed,ff", "fanin"),
            "w_up": D(L + (e, d, f), f"{ln}experts,embed,ff", "fanin"),
            "w_down": D(L + (e, f, d), f"{ln}experts,ff,embed", "fanin"),
        }
    if cfg.mlp == "swiglu":
        return {
            "w_gate": D(L + (d, f), f"{ln}embed,ff", "fanin"),
            "w_up": D(L + (d, f), f"{ln}embed,ff", "fanin"),
            "w_down": D(L + (f, d), f"{ln}ff,embed", "fanin"),
        }
    return {
        "w_up": D(L + (d, f), f"{ln}embed,ff", "fanin"),
        "b_up": D(L + (f,), f"{ln}ff", "zeros"),
        "w_down": D(L + (f, d), f"{ln}ff,embed", "fanin"),
        "b_down": D(L + (d,), f"{ln}embed_nofsdp", "zeros"),
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
    The slices are views; nothing is copied. A `Sharded` leaf (a mesh's) is
    sliced part by part."""
    if is_clustered(tree):
        return map_arrays(tree, lambda a: a[l])
    if isinstance(tree, dict):
        return {k: layer_slice(v, l) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.map(lambda p: layer_slice(p, l), dims_dropped=1)
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


def _mlp(cfg: ModelConfig, p: Dict[str, Any],
         h: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's MLP: (out, aux). The MoE block's aux is its f32
    load-balancing loss; the dense MLP has none (None, so that a serving
    step launches nothing for it)."""
    if cfg.n_experts:
        return moe_block(p, h, cfg)
    return mlp_block(p, h, cfg), None


def _block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor, window: int,
           cache: Optional[Dict[str, Any]] = None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = norm(x, p["ln_attn"], cfg.norm)
    x = x + attn_block(p["attn"], h, cfg, layer_window=window, cache=cache)
    h = norm(x, p["ln_mlp"], cfg.norm)
    out, aux = _mlp(cfg, p["mlp"], h)
    return x + out, aux


# ---------------------------------------------------------------------------
# Forward (full sequence: train / prefill / evaluation)
# ---------------------------------------------------------------------------

# what remat_policy="dots" keeps: the outputs of the matmuls with no batch
# dimension (the projections; the JAX package's
# dots_with_no_batch_dims_saveable). Attention's batched products and
# everything else are recomputed in the backward.
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(cfg: ModelConfig, fn, *args):
    """fn(*args) under `torch.utils.checkpoint`, one layer's body: with
    `cfg.remat_policy` "nothing" only the inputs are kept and the rest is
    recomputed in the backward; "dots" also keeps the projections' outputs.
    The counterpart of the JAX package's `jax.checkpoint` around its scanned
    body, shared by every family's forward. The args may hold a training
    mesh's `Sharded` weights (the non-reentrant checkpoint records the
    graph to every part and recomputes only what it did not save)."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(_save_dots)
    elif cfg.remat_policy != "nothing":
        raise ValueError(f"remat_policy must be 'nothing' or 'dots'; got "
                         f"{cfg.remat_policy!r}")
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def _remat_block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                 window: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`_block` under `remat_call`. The MoE block sits inside, like the
    dense MLP."""
    return remat_call(cfg, _block, cfg, p, x, window)


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,                        # (B, S)
    cfg: ModelConfig,
    *,
    prefix_embeds: Optional[torch.Tensor] = None,   # (B, P, d) VLM patch embeds
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B, P + S, padded_vocab), aux),
    aux the f32 sum over layers of the MoE blocks' load-balancing losses (a
    zero for the dense family).

    Differentiable: training takes gradients through it, so there is no
    `torch.no_grad()` here and evaluation callers wrap it themselves. With
    `cfg.remat` and autograd on, each layer's body runs under
    `torch.utils.checkpoint` (`cfg.remat_policy`), as the JAX package wraps
    its scanned body in `jax.checkpoint`. Clustered weights go through
    `kernels.ops.clustered_linear` / `clustered_linear_multi`: on the card
    the LUT GEMMs at B * S rows. On a training mesh (`launch/steps.py
    build_train_step` on a placed state) the projections arrive cut over
    the model axis (`Sharded`) and `layers.attn_block` / `mlp_block` /
    `moe_block` run each rank's part; the embedding, norms and head are
    whole."""
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]     # (B, S, d)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    windows = layer_windows(cfg)
    blocks = params["blocks"]
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.n_layers):
        p, w = layer_slice(blocks, l), int(windows[l])
        x, a = _remat_block(cfg, p, x, w) if remat else _block(cfg, p, x, w)
        if a is not None:
            aux = aux + a
    x = norm(x, params["ln_final"], cfg.norm)
    return lm_head_logits(params, x, cfg), aux


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
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]     # (B, S, d)
    windows = layer_windows(cfg)
    blocks = params["blocks"]
    for l in range(cfg.n_layers):
        lcache = {name: t[l] for name, t in cache.items() if name != "pos"}
        lcache["pos"] = pos
        x, _ = _block(cfg, layer_slice(blocks, l), x, int(windows[l]), cache=lcache)
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


CACHE_NAMES = {"k": "layers,batch,seq_kv,kv,.", "v": "layers,batch,seq_kv,kv,.",
               "pos": "", "k_scale": "layers,batch,seq_kv,kv",
               "v_scale": "layers,batch,seq_kv,kv"}


PAGED_CACHE_NAMES = {"k": "layers,blocks,.,kv,.", "v": "layers,blocks,.,kv,.",
                     "k_scale": "layers,blocks,.,kv", "v_scale": "layers,blocks,.,kv",
                     "k_smooth": "layers,kv,.", "v_smooth": "layers,kv,."}


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
    int and every ragged quantity is a mask. An MoE layer routes all S * T
    tokens of the step together, the idle slots' and the padding's too, as
    the JAX package's does; its aux loss is dropped."""
    x = params["embed"].to(cfg.torch_dtype)[tokens.long()]     # (S, T, d)
    for l in range(cfg.n_layers):
        p = layer_slice(params["blocks"], l)
        x = _paged_attn_half(p, x, cache, l, block_tables, lengths, n_new, cfg)
        h = norm(x, p["ln_mlp"], cfg.norm)
        x = x + _mlp(cfg, p["mlp"], h)[0]

    return norm(x, params["ln_final"], cfg.norm)


def _paged_attn_half(p, x, cache, l: int, block_tables, lengths, n_new,
                     cfg: ModelConfig) -> torch.Tensor:
    """Layer l's attention half over the paged pool: x + attn(norm(x))."""
    kv_kw = dict(kc=layer_slice(cache["k"], l), vc=layer_slice(cache["v"], l))
    if cache["k"].dtype == torch.int8:
        kv_kw.update({kw: layer_slice(cache[name], l) for kw, name in (
            ("kc_scale", "k_scale"), ("vc_scale", "v_scale"), ("k_smooth", "k_smooth"),
            ("v_smooth", "v_smooth"))})
    h = norm(x, p["ln_attn"], cfg.norm)
    return x + paged_attn_block(
        p["attn"], h, cfg, layer_window=int(layer_windows(cfg)[l]),
        block_tables=block_tables, lengths=lengths, n_new=n_new, **kv_kw)


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
    if isinstance(params, MeshTree):
        return _mesh_step(params, cache, tokens, lengths, n_new, block_tables, cfg,
                          _last_valid), cache
    last = _last_valid(_paged_trunk(params, cache, tokens, lengths, n_new, block_tables,
                                    cfg), n_new)
    return lm_head_logits(params, last, cfg), cache


def _last_valid(x: torch.Tensor, n_new: torch.Tensor) -> torch.Tensor:
    """Each slot's hidden state at its last valid token, (S, d): the lm_head
    runs only there, so the padded tail of a prefill chunk never reaches the
    vocab matmul."""
    last_idx = torch.clamp(n_new - 1, min=0).long()
    return x[torch.arange(x.shape[0], device=x.device), last_idx]


def _mesh_step(params: MeshTree, cache: MeshTree, tokens, lengths, n_new, block_tables,
               cfg: ModelConfig, rows_of=None) -> torch.Tensor:
    """The paged step on a (data, model) mesh, from one process: each data
    rank runs the trunk over its slots (`data_rows`) on its tree of shards
    (`_paged_trunk`: each model rank's LUT projections on its column shard,
    B5 on its kv heads, the parts combined at `maybe_shard`; an MoE model
    layer by layer, `_moe_mesh_trunk`); the data ranks' hidden rows are
    gathered in rank order and the head runs ONCE over every row, whole, as
    on one device: cuBLAS picks the head's kernel by its (rows, columns),
    and a row's bits must not depend on the mesh (ROADMAP C). `rows_of(x,
    n_new)` picks the rows the head needs (the last valid token's, or every
    position for the verify). Returns the logits on the mesh's first
    device; the pools were written in place. A process mesh runs
    `_process_mesh_step`."""
    mesh = params.mesh
    rows_all = data_rows(mesh, tokens.shape[0])
    if is_process_mesh(mesh):
        return _process_mesh_step(params, cache, tokens, lengths, n_new, block_tables, cfg,
                                  rows_of, rows_all)
    with use_rules(mesh, fsdp=False):
        ranks = []
        for d, rows in enumerate(rows_all):
            dev = mesh.device_at(data=d)
            ranks.append([a[rows].to(dev) for a in (tokens, lengths, n_new, block_tables)])
        if cfg.n_experts:
            xs = _moe_mesh_trunk(params, cache, ranks, rows_all, cfg)
        else:
            xs = [_paged_trunk(params.views[d], cache.views[d], *args, cfg)
                  for d, args in enumerate(ranks)]
        outs = [x if rows_of is None else rows_of(x, args[2]) for x, args in zip(xs, ranks)]
        if rows_all[0] == slice(None):     # every data rank ran every slot
            x = outs[0]
        else:                              # the head's rows: every data rank's
            x = maybe_shard(Sharded(tuple(outs), 0, axis="data"), *[None] * outs[0].ndim)
    return lm_head_logits(params.views[0], x, cfg)


def _process_mesh_step(params: MeshTree, cache: MeshTree, tokens, lengths, n_new,
                       block_tables, cfg: ModelConfig, rows_of, rows_all) -> torch.Tensor:
    """`_mesh_step` as one process of a process mesh runs it: the trunk over
    its data rank's slots on its own shards (the model ranks' parts
    combined by all-gathers over its model group). Where the data ranks
    split the slots, every K / V row a data rank writes reaches every
    process's pool replica (`collectives.exchange_rows`) and the head's
    rows are all-gathered over the data group in rank order; the head then
    runs once, whole, on every process. Where they do not (the
    divisibility fallback) every process runs every slot and needs
    neither."""
    mesh = params.mesh
    d, dev = mesh.coord["data"], mesh.device
    split = rows_all[0] != slice(None)
    args = [a[rows_all[d]].to(dev) for a in (tokens, lengths, n_new, block_tables)]
    with use_rules(mesh, fsdp=False), exchange_rows(mesh.group("data") if split else None):
        x = _paged_trunk(params.views[0], cache.views[0], *args, cfg)
        x = x if rows_of is None else rows_of(x, args[2])
        if split:
            x = all_gather(x, mesh.group("data"), 0)
    return lm_head_logits(params.views[0], x, cfg)


def _moe_mesh_trunk(params: MeshTree, cache: MeshTree, ranks, rows_all, cfg: ModelConfig):
    """`_paged_trunk` of an MoE model on a mesh, layer by layer over the
    data ranks: each data rank's attention half over its slots, then its
    normed rows gathered in rank order (slot order: `data_rows` are
    contiguous) so that `moe_block` routes the step's whole token set ONCE,
    the idle slots' pad tokens included, as on one device (routing per data
    rank would form other groups with other capacities and drops); its
    output is split back to the data ranks. Each model rank runs its
    experts (`layers.moe_block`). Returns each data rank's final-norm
    hidden rows."""
    views, split = params.views, rows_all[0] != slice(None)
    xs = [views[d]["embed"].to(cfg.torch_dtype)[args[0].long()] for d, args in enumerate(ranks)]
    for l in range(cfg.n_layers):
        ps = [layer_slice(v["blocks"], l) for v in views]
        xs = [_paged_attn_half(ps[d], x, cache.views[d], l, args[3], args[1], args[2], cfg)
              for d, (x, args) in enumerate(zip(xs, ranks))]
        hs = [norm(x, p["ln_mlp"], cfg.norm) for x, p in zip(xs, ps)]
        h = maybe_shard(Sharded(tuple(hs), 0, axis="data"), None, None, None) if split else hs[0]
        out = _mlp(cfg, ps[0]["mlp"], h)[0]
        outs = out.split([x.shape[0] for x in xs]) if split else [out] * len(xs)
        xs = [x + o.to(x.device) for x, o in zip(xs, outs)]
    return [norm(x, v["ln_final"], cfg.norm) for x, v in zip(xs, views)]


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
    if isinstance(params, MeshTree):
        return _mesh_step(params, cache, tokens, lengths, n_new, block_tables, cfg), cache
    x = _paged_trunk(params, cache, tokens, lengths, n_new, block_tables, cfg)
    return lm_head_logits(params, x, cfg), cache
