"""Whisper-large-v3 backbone: an encoder-decoder transformer (arXiv:2212.04356).

As in the JAX package the conv frontend is a stub: the encoder takes
precomputed frame embeddings (B, enc_seq = 1500, d_model), the output of the
two-conv mel-spectrogram stem. Whisper uses LayerNorm, GELU MLPs with
biases, absolute positions (sinusoidal in the encoder, learned in the
decoder; no RoPE), MHA (kv heads = heads, padded with them) and a decoder
head tied to the token embedding.

Every projection is a solo `layers.linear` (on the card the LUT GEMV below
128 rows, the LUT GEMM from 128 on: the encoder and the cross-K/V build run
at enc_seq = 1500 rows a request). The attention is plain PyTorch, as in
the JAX package: `layers.attention` over a whole sequence or a contiguous
cache, `layers.ragged_attention` (`_attn_chunk` in blocks of 32 query rows)
over the slot state.

The engine serves this family through per-slot state (`init_slot_state`):
the decoder's self K/V, written at each slot's positions, and the
cross-attention K/V, written once per request at admission by
`encode_prefill` (the engine's "encode" shape). Where the JAX package scans
over layers, this module loops over them in Python and indexes the stacked
(L, ...) parameters; the static cache and the slot state are updated IN
PLACE.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.distributed.placement import MeshTree
from repro_torch.distributed.sharding import rank_parts, whole
from repro_torch.models import params as PT
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_absmax_int8, _scatter_rows, attention,
                                       layernorm, linear, ragged_attention)
from repro_torch.models.slot_state import per_head_ranks, slot_serving_step
from repro_torch.models.transformer import layer_slice, remat_call

D = PT.ParamDecl


def _ln(cfg: ModelConfig, L: Optional[int] = None) -> Dict[str, D]:
    shape = ((L,) if L else ()) + (cfg.d_model,)
    n = ("layers," if L else "") + "embed_nofsdp"
    return {"scale": D(shape, n, "ones", "float32"),
            "bias": D(shape, n, "zeros", "float32")}


def _attn(cfg: ModelConfig, L: int) -> Dict[str, D]:
    d, qd = cfg.d_model, cfg.q_dim_eff
    ln = "layers,"
    return {
        "wq": D((L, d, qd), ln + "embed,q_dim", "fanin"),
        "wk": D((L, d, qd), ln + "embed,q_dim", "fanin"),
        "wv": D((L, d, qd), ln + "embed,q_dim", "fanin"),
        "wo": D((L, qd, d), ln + "q_dim,embed", "fanin"),
    }


def _mlp(cfg: ModelConfig, L: int) -> Dict[str, D]:
    d, f = cfg.d_model, cfg.d_ff
    ln = "layers,"
    return {
        "w_up": D((L, d, f), ln + "embed,ff", "fanin"),
        "b_up": D((L, f), ln + "ff", "zeros"),
        "w_down": D((L, f, d), ln + "ff,embed", "fanin"),
        "b_down": D((L, d), ln + "embed_nofsdp", "zeros"),
    }


def param_table(cfg: ModelConfig) -> PT.Table:
    Le, Ld, d = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
    return {
        "enc": {
            "blocks": {
                "ln_attn": _ln(cfg, Le), "attn": _attn(cfg, Le),
                "ln_mlp": _ln(cfg, Le), "mlp": _mlp(cfg, Le),
            },
            "ln_final": _ln(cfg),
        },
        "dec": {
            "embed": D((cfg.padded_vocab, d), "vocab,embed", "embed"),
            # learned positions sized as the JAX package sizes them (real
            # whisper caps at 448)
            "pos_embed": D((32768, d), ".,embed_nofsdp", "normal:0.01"),
            "blocks": {
                "ln_self": _ln(cfg, Ld), "self_attn": _attn(cfg, Ld),
                "ln_cross": _ln(cfg, Ld), "cross_attn": _attn(cfg, Ld),
                "ln_mlp": _ln(cfg, Ld), "mlp": _mlp(cfg, Ld),
            },
            "ln_final": _ln(cfg),
        },
    }


def _sinusoid(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10_000 ** (2 * dim / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def _norm(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return layernorm(x, p["scale"], p["bias"])


def _mha(p, x, cfg: ModelConfig, *, kv_src=None, causal: bool,
         cache: Optional[Dict[str, Any]] = None):
    """Whisper attention: no rope, MHA; (out, the self cache's tensors or
    None). `kv_src` is the encoder output for cross-attention, or (with a
    cache holding "ck" / "cv") only a flag that this is the cross block.

    With a self cache ({"k", "v", "pos"[, "k_scale", "v_scale"]}, one
    layer's views) this step's K/V are written at `pos` (a 0-d int32 tensor
    on the cache's device, or a host int) IN PLACE, optionally as int8
    absmax codes with per-(token, head) scales, and the queries attend over
    the whole cache, later positions masked by causality."""
    b, s, _ = x.shape
    nh, hd = cfg.n_heads_eff, cfg.hd
    src = x if kv_src is None else kv_src
    q = linear(x, p["wq"])
    if cache is not None:
        q = whole(q).reshape(b, s, nh, hd)
    if cache is not None and "k" in cache and kv_src is None:
        k = whole(linear(x, p["wk"])).reshape(b, s, nh, hd)
        v = whole(linear(x, p["wv"])).reshape(b, s, nh, hd)
        kc, vc = cache["k"], cache["v"]
        pos = cache["pos"] + torch.arange(s, device=x.device)
        if kc.dtype == torch.int8:
            kq, ks_new = _absmax_int8(k)
            vq, vs_new = _absmax_int8(v)
            kc.index_copy_(1, pos, kq)
            vc.index_copy_(1, pos, vq)
            cache["k_scale"].index_copy_(1, pos, ks_new)
            cache["v_scale"].index_copy_(1, pos, vs_new)
            kd = kc.to(x.dtype) * cache["k_scale"][..., None].to(x.dtype)
            vd = vc.to(x.dtype) * cache["v_scale"][..., None].to(x.dtype)
        else:
            kc.index_copy_(1, pos, k.to(kc.dtype))
            vc.index_copy_(1, pos, v.to(vc.dtype))
            kd, vd = kc, vc
        o = attention(q, kd, vd, causal=True, q_offset=cache["pos"])
        return whole(linear(o.reshape(b, s, nh * hd), p["wo"])), cache
    if cache is not None and kv_src is None and "k" not in cache:
        raise ValueError("bad cache")
    if cache is not None and kv_src is not None:
        # cross-attention over the precomputed encoder K/V
        o = attention(q, cache["ck"], cache["cv"], causal=False)
        return whole(linear(o.reshape(b, s, nh * hd), p["wo"])), None
    sk = src.shape[1]

    def heads(q, k, v, _):
        h = q.shape[-1] // hd
        o = attention(q.reshape(b, s, h, hd), k.reshape(b, sk, h, hd),
                      v.reshape(b, sk, h, hd), causal=causal)
        return o.reshape(b, s, h * hd), None

    # on a mesh q, k and v arrive cut by their columns: each model rank
    # attends with its own heads, padded heads included
    o, _ = per_head_ranks(heads, None, (q, linear(src, p["wk"]), linear(src, p["wv"])),
                          (-1, -1, -1), heads=nh)
    return whole(linear(o, p["wo"])), None


def _gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """The gelu MLP; on a mesh each projection on its rank's columns, the
    activation on the gathered hidden."""
    h = F.gelu(whole(linear(x, p["w_up"], p["b_up"])), approximate="tanh")
    return whole(linear(h, p["w_down"], p["b_down"]))


def _enc_block(p, x, cfg: ModelConfig):
    a, _ = _mha(p["attn"], _norm(x, p["ln_attn"]), cfg, causal=False)
    x = x + a
    return x + _gelu_mlp(p["mlp"], _norm(x, p["ln_mlp"]))


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, enc_seq, d) precomputed conv-stem output (the stub
    frontend) -> the encoder output (B, enc_seq, d). Differentiable; with
    `cfg.remat` and autograd on, each layer runs under
    `torch.utils.checkpoint` (`transformer.remat_call`)."""
    dt = cfg.torch_dtype
    sin = torch.from_numpy(_sinusoid(frames.shape[1], cfg.d_model))
    x = frames.to(dt) + sin.to(frames.device, dt)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    blocks = params["enc"]["blocks"]
    for l in range(cfg.n_enc_layers):
        p = layer_slice(blocks, l)
        x = remat_call(cfg, _enc_block, p, x, cfg) if remat else _enc_block(p, x, cfg)
    return _norm(x, params["enc"]["ln_final"])


def _dec_block(p, x, enc_out, cfg: ModelConfig):
    a, _ = _mha(p["self_attn"], _norm(x, p["ln_self"]), cfg, causal=True)
    x = x + a
    a, _ = _mha(p["cross_attn"], _norm(x, p["ln_cross"]), cfg, kv_src=enc_out,
                causal=False)
    x = x + a
    return x + _gelu_mlp(p["mlp"], _norm(x, p["ln_mlp"]))


def _head(dec, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the tied head (whisper's logits are x · embedᵀ)."""
    x = _norm(x, dec["ln_final"])
    return x @ dec["embed"].to(x.dtype).T


def decode_full(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher-forced decoder over the whole token sequence (train,
    prefill): (logits (B, S, padded_vocab), a zero aux)."""
    dec = params["dec"]
    s = tokens.shape[1]
    x = dec["embed"].to(cfg.torch_dtype)[tokens.long()]
    x = x + dec["pos_embed"][:s].to(x.dtype)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(cfg.n_layers):
        p = layer_slice(dec["blocks"], l)
        x = (remat_call(cfg, _dec_block, p, x, enc_out, cfg) if remat
             else _dec_block(p, x, enc_out, cfg))
    return _head(dec, x), torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return decode_full(params, tokens, encode(params, frames, cfg), cfg)


# --- decode cache: self K/V per decoder layer + precomputed cross K/V ---------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, Any]:
    """The static path's cache: the decoder's self K/V (L, B, max_seq, H, D)
    in the model dtype, or int8 codes with (L, B, max_seq, H) f32 scales when
    cfg.kv_cache_dtype is "int8"; the cross K/V (L, B, enc_seq, H, D), zero
    until the caller fills them (`build_cross_cache`); `pos`, a 0-d int32
    tensor that `decode_step` advances in place."""
    L, nh, hd = cfg.n_layers, cfg.n_heads_eff, cfg.hd
    f = cfg.torch_dtype
    int8 = cfg.kv_cache_dtype == "int8"
    sf = torch.int8 if int8 else f
    c = {
        "k": torch.zeros((L, batch, max_seq, nh, hd), dtype=sf, device=device),
        "v": torch.zeros((L, batch, max_seq, nh, hd), dtype=sf, device=device),
        "ck": torch.zeros((L, batch, cfg.enc_seq, nh, hd), dtype=f, device=device),
        "cv": torch.zeros((L, batch, cfg.enc_seq, nh, hd), dtype=f, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
    if int8:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.full((L, batch, max_seq, nh), 1e-6, dtype=torch.float32,
                                 device=device)
    return c


CACHE_NAMES = {
    "k": "layers,batch,seq_kv,kv,.", "v": "layers,batch,seq_kv,kv,.",
    "ck": "layers,batch,.,kv,.", "cv": "layers,batch,.,kv,.",
    "pos": "", "k_scale": "layers,batch,seq_kv,kv",
    "v_scale": "layers,batch,seq_kv,kv",
}


def build_cross_cache(params, enc_out: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K/V from the encoder output: two solo
    projections a layer (where the JAX package vmaps over the layers), each
    stacked to (L, B, enc_seq, H, D)."""
    b, se, _ = enc_out.shape
    nh, hd = cfg.n_heads_eff, cfg.hd
    cross = params["dec"]["blocks"]["cross_attn"]
    ks, vs = [], []
    for l in range(cfg.n_layers):
        p = layer_slice(cross, l)
        ks.append(whole(linear(enc_out, p["wk"])).reshape(b, se, nh, hd))
        vs.append(whole(linear(enc_out, p["wv"])).reshape(b, se, nh, hd))
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: ModelConfig):
    """One static-path step of the decoder over `tokens` (B, S) at positions
    pos.. (`pos` a 0-d int32 tensor, normally `cache["pos"]`, or a host int;
    read on the device only): the self K/V are written in place, the cross
    K/V read. Returns the last token's logits (B, padded_vocab) and the
    cache, its `pos` advanced by ONE whatever S is, as the JAX package's."""
    dec = params["dec"]
    s = tokens.shape[1]
    x = dec["embed"].to(cfg.torch_dtype)[tokens.long()]
    at = pos + torch.arange(s, device=x.device)
    x = x + dec["pos_embed"].index_select(0, at).to(x.dtype)[None]
    int8 = cache["k"].dtype == torch.int8
    for l in range(cfg.n_layers):
        p = layer_slice(dec["blocks"], l)
        lc = {"k": cache["k"][l], "v": cache["v"][l], "pos": pos}
        if int8:
            lc["k_scale"], lc["v_scale"] = cache["k_scale"][l], cache["v_scale"][l]
        a, _ = _mha(p["self_attn"], _norm(x, p["ln_self"]), cfg, causal=True, cache=lc)
        x = x + a
        a, _ = _mha(p["cross_attn"], _norm(x, p["ln_cross"]), cfg, kv_src=x,  # a flag only
                    causal=False, cache={"ck": cache["ck"][l], "cv": cache["cv"][l]})
        x = x + a
        x = x + _gelu_mlp(p["mlp"], _norm(x, p["ln_mlp"]))
    cache["pos"].fill_(pos + 1)
    return _head(dec, x[:, -1]), cache


# --- serving: per-slot state, the encoder as a second prefill shape ----------

def init_slot_state(cfg: ModelConfig, num_slots: int, max_seq: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    L, nh, hd = cfg.n_layers, cfg.n_heads_eff, cfg.hd
    f = cfg.torch_dtype
    return {
        "k": torch.zeros((L, num_slots, max_seq, nh, hd), dtype=f, device=device),
        "v": torch.zeros((L, num_slots, max_seq, nh, hd), dtype=f, device=device),
        "ck": torch.zeros((L, num_slots, cfg.enc_seq, nh, hd), dtype=f, device=device),
        "cv": torch.zeros((L, num_slots, cfg.enc_seq, nh, hd), dtype=f, device=device),
    }


SLOT_STATE_NAMES = {
    "k": "layers,slots,seq_kv,kv,.", "v": "layers,slots,seq_kv,kv,.",
    "ck": "layers,slots,enc_seq,kv,.", "cv": "layers,slots,enc_seq,kv,.",
}


@torch.no_grad()
def encode_prefill(params, frames: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One request's encoder pass: frames (1, enc_seq, d) -> its cross K/V,
    each (L, enc_seq, H, D). Run once at admission (profiler range
    "audio.encode"). On a mesh the encoder runs once on data rank 0's tree,
    each projection on its model ranks' columns, and the engine writes each
    model rank's kv heads into its part of the slot's cross K/V."""
    if isinstance(params, MeshTree):
        params = params.views[0]
    with record_function("audio.encode"):
        ks, vs = build_cross_cache(params, encode(params, frames, cfg), cfg)
    return ks[:, 0], vs[:, 0]


def _serving_trunk(params, caches, tokens, lengths, n_new, block_tables,
                   cfg: ModelConfig) -> torch.Tensor:
    """The engine step's decoder window (slots, T): one ragged attention
    pass (`layers.ragged_attention`: a row's bits the same at every width
    and slot count), per-slot positions indexing the learned position table
    and the self K/V write sites. A token past its slot's n_new writes
    nothing (`layers._scatter_rows`); keys at or past a slot's lengths +
    n_new are masked. The self K/V are written IN PLACE (the engine's graphs
    read those tensors). On a mesh the self and cross K/V are `Sharded` by
    heads: each model rank writes and attends over its heads (its columns of
    wq, wk and wv are exactly those heads), the outputs gathered for `wo`;
    everything else runs whole. Returns each slot's hidden row (before the
    final norm) at its last valid token, (slots, d) — an idle slot's at
    position 0. `block_tables` is unused: slot state has no pages."""
    del block_tables
    state = caches["slot"]
    dec = params["dec"]
    s_slots, t = tokens.shape
    nh, hd = cfg.n_heads_eff, cfg.hd
    max_seq = rank_parts(state["k"])[0].shape[2]
    dev = tokens.device

    steps = torch.arange(t, dtype=lengths.dtype, device=dev)
    pos = lengths[:, None] + steps[None, :]                       # (S, T) absolute
    valid = steps[None, :] < n_new[:, None]
    # the write sites of the slots' stacked rows; a site past max_seq drops,
    # as the JAX package's out-of-range scatter does
    wvalid = (valid & (pos < max_seq)).reshape(-1)
    slot_ix = torch.arange(s_slots, device=dev)[:, None]
    idx = (slot_ix * max_seq + torch.clamp(pos, max=max_seq - 1)).reshape(-1).long()
    k_pos = torch.arange(max_seq, device=dev)
    e_pos = torch.arange(rank_parts(state["ck"])[0].shape[2], device=dev)
    k_len = lengths + n_new
    scale = 1.0 / math.sqrt(hd)

    def self_attn(q, k, v, kc, vc):
        k, v = (a.reshape(s_slots * t, -1, hd) for a in (k, v))
        _scatter_rows(kc, idx, k.to(kc.dtype), wvalid)
        _scatter_rows(vc, idx, v.to(vc.dtype), wvalid)
        with record_function("audio.self_attn"):
            return ragged_attention(q.reshape(s_slots, t, -1, hd), kc, vc, pos, k_pos,
                                    causal=True, scale=scale, k_len=k_len), None

    def cross_attn(q, ck, cv):
        with record_function("audio.cross_attn"):
            return ragged_attention(q.reshape(s_slots, t, -1, hd), ck, cv, pos, e_pos,
                                    causal=False, scale=scale), None

    x = dec["embed"].to(cfg.torch_dtype)[tokens.long()]
    x = x + dec["pos_embed"][torch.where(valid, pos, 0).long()].to(x.dtype)
    for l in range(cfg.n_layers):
        p = layer_slice(dec["blocks"], l)
        at = p["self_attn"]
        h = _norm(x, p["ln_self"])
        o, _ = per_head_ranks(self_attn, (layer_slice(state["k"], l), layer_slice(state["v"], l)),
                              [linear(h, at[w]) for w in ("wq", "wk", "wv")], (-1, -1, -1))
        x = x + whole(linear(o.reshape(s_slots, t, nh * hd), at["wo"]))
        at = p["cross_attn"]
        h = _norm(x, p["ln_cross"])
        o, _ = per_head_ranks(cross_attn, (layer_slice(state["ck"], l),
                                           layer_slice(state["cv"], l)),
                              [linear(h, at["wq"])], (-1,))
        x = x + whole(linear(o.reshape(s_slots, t, nh * hd), at["wo"]))
        x = x + _gelu_mlp(p["mlp"], _norm(x, p["ln_mlp"]))
    return x[torch.arange(s_slots, device=dev), torch.clamp(n_new - 1, min=0).long()]


def _serving_head(params, x, cfg: ModelConfig) -> torch.Tensor:
    return _head(params["dec"], x)


# The engine step: (the logits at each slot's last valid token (slots,
# padded_vocab), `caches`, whose slot state was updated in place).
serving_step = slot_serving_step(_serving_trunk, _serving_head)
