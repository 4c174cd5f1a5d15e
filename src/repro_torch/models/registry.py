"""Model registry: one uniform interface over the ported architecture families.

    model = get_model(cfg)                      # cfg or arch-id string
    params = model.init(generator, device)      # real tensors
    logits, aux = model.apply(params, {"tokens": t})    # full sequence
    loss = lm_loss(logits, targets, loss_mask, model.cfg.vocab)
    caches = model.init_seq_caches(num_blocks=..., block_size=...,
                                   num_slots=..., max_seq=..., device=...)
    logits, caches = model.serving_step(params, caches, tokens, lengths,
                                        n_new, block_tables)
    logits, caches = model.serving_verify(params, caches, tokens, lengths,
                                          n_new, block_tables)   # every position
    cache = model.init_cache(batch, max_seq, device)          # static path
    logits, cache = model.decode(params, cache, {"tokens": t, "pos": cache["pos"]})

Serving surface (launch/engine.py): each family publishes the sequence caches
it serves through, keyed by kind,

    "paged"  PagedSeqCache  — a block-table pool over (num_blocks, block_size)
                              rows; grows per token, supports sharing / COW;
    "slot"   SlotStateCache — fixed-size per-slot state; the slot IS the
                              allocator (no paging, no block tables);

plus a capability set telling the engine which features apply, and one
`serving_step(params, caches, tokens, lengths, n_new, block_tables)` that
threads every cache the family declared through one step. The dense, moe and
vlm transformers serve through the paged step (an MoE arch with
`layers.moe_block` as its MLP; paligemma-3b's text decoder, its image prefix
taken by the full-sequence forward as `batch["img_embeds"]`); rwkv6 and gla
through slot state; zamba2 through both; whisper (the audio family) through
slot state, its encoder run once a request at admission
(`model.encode_prefill(params, frames)`, `CAP_ENCODER`) and its full-sequence
forward taking the frames as `batch["frames"]`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch

from repro_torch.models import gla, rwkv6, transformer, whisper, zamba2
from repro_torch.models import params as PT
from repro_torch.models.config import ModelConfig, get_config

# --- capabilities ------------------------------------------------------------

CAP_PAGED = "paged"              # serves through a paged block pool
CAP_SLOT_STATE = "slot_state"    # serves through fixed-size per-slot state
CAP_SPECULATIVE = "speculative"  # width-(k+1) verify over the paged pool
CAP_PREFIX_CACHE = "prefix_cache"  # content-hashed block sharing + COW
CAP_INT8_KV = "int8_kv"          # smoothed int8 block pool
CAP_SNAPSHOT = "snapshot"        # preemption snapshots/restores slot state
CAP_ENCODER = "encoder"          # encoder pass at admission

_TRANSFORMER_CAPS = frozenset(
    {CAP_PAGED, CAP_SPECULATIVE, CAP_PREFIX_CACHE, CAP_INT8_KV})
_RECURRENT_CAPS = frozenset({CAP_SLOT_STATE, CAP_SNAPSHOT})

# the capability sets of every family the JAX package serves
FAMILY_CAPS: Dict[str, frozenset] = {
    "dense": _TRANSFORMER_CAPS,
    "moe": _TRANSFORMER_CAPS,
    "vlm": _TRANSFORMER_CAPS,
    "rwkv": _RECURRENT_CAPS,
    "linear_attn": _RECURRENT_CAPS,
    "hybrid": frozenset({CAP_PAGED, CAP_SLOT_STATE}),
    "audio": frozenset({CAP_SLOT_STATE, CAP_SNAPSHOT, CAP_ENCODER}),
}

PORTED_FAMILIES = ("dense", "moe", "vlm", "rwkv", "linear_attn", "hybrid", "audio")


def family_capabilities(family: str) -> frozenset:
    if family not in FAMILY_CAPS:
        raise ValueError(
            f"unknown model family {family!r}; registered families: "
            f"{', '.join(sorted(FAMILY_CAPS))}")
    return FAMILY_CAPS[family]


def arch_capabilities(arch_id: str) -> frozenset:
    """Capability set for a registered arch id (ValueError when unknown)."""
    return family_capabilities(get_config(arch_id).family)


# --- sequence-cache protocols ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedSeqCache:
    """Block-table KV pool: rows of (num_blocks, block_size) pages.

    init(cfg, num_blocks, block_size, kv_dtype, device) -> pool dict. The
    engine owns allocation (BlockAllocator), sharing and copy-on-write."""
    init: Callable
    names: Mapping[str, str]
    kind: str = dataclasses.field(default="paged", init=False)


@dataclasses.dataclass(frozen=True)
class SlotStateCache:
    """Fixed-size per-slot sequence state (axis 1 of every leaf = slot).

    init(cfg, num_slots, max_seq, device) -> state dict. There is no
    allocator: admitting a request resets its slot; preemption (where
    `snapshot`) copies the slot's rows out and back instead of recomputing."""
    init: Callable
    names: Mapping[str, str]
    snapshot: bool = True
    kind: str = dataclasses.field(default="slot", init=False)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    table: PT.Table
    capabilities: frozenset = frozenset()
    # serving surface: cache protocols by kind, and one step threading them
    seq_caches: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _apply: Optional[Callable] = None
    _serving_step: Optional[Callable] = None
    _serving_verify: Optional[Callable] = None
    _decode: Optional[Callable] = None
    _init_cache: Optional[Callable] = None
    _encode_prefill: Optional[Callable] = None

    def init(self, generator: torch.Generator, device="cuda"):
        return PT.init_params(generator, self.table, self.cfg.torch_dtype,
                              device)

    def abstract(self):
        """The parameter tree as tensors on the "meta" device: shapes and
        dtypes, no storage (the JAX package's ShapeDtypeStruct tree)."""
        return PT.map_table(self.table, lambda _, d: torch.empty(
            d.shape, dtype=PT.decl_dtype(d, self.cfg.torch_dtype), device="meta"))

    def names(self):
        """The tree of comma-joined logical dim names, one per parameter."""
        return PT.map_table(self.table, lambda _, d: d.names)

    @property
    def cache_names(self) -> Dict[str, str]:
        """Logical dim names of the static path's cache (`init_cache`)."""
        return getattr(_MODULES.get(self.cfg.family), "CACHE_NAMES", {})

    def apply(self, params, batch: Dict[str, Any]):
        """Full-sequence forward: batch = {"tokens": (B, S)[, "img_embeds":
        (B, P, d)][, "frames": (B, enc_seq, d), the audio family's]}. Returns
        (logits (B, S, padded_vocab) aligned with the text tokens, aux).
        Differentiable; not under `torch.no_grad()`."""
        return self._apply(params, batch, self.cfg)

    def decode(self, params, cache, batch: Dict[str, Any]):
        """One static-path step: batch = {"tokens": (B, S), "pos": the 0-d
        int32 position tensor (normally cache["pos"]) or a host int}. Returns
        (last-token logits, the cache, updated in place, its `pos` advanced)."""
        return self._decode(params, cache, batch, self.cfg)

    def init_cache(self, batch: int, max_seq: int, device="cuda"):
        return self._init_cache(self.cfg, batch, max_seq, device)

    def param_count(self) -> int:
        return PT.param_count(self.table)

    def supports(self, cap: str) -> bool:
        return cap in self.capabilities

    def init_seq_caches(self, *, num_blocks: int, block_size: int,
                        num_slots: int, max_seq: int,
                        kv_dtype: Optional[str] = None,
                        device="cuda") -> Dict[str, Any]:
        """Instantiate every cache this family serves through, keyed by kind."""
        caches: Dict[str, Any] = {}
        if "paged" in self.seq_caches:
            caches["paged"] = self.seq_caches["paged"].init(
                self.cfg, num_blocks, block_size, kv_dtype, device)
        if "slot" in self.seq_caches:
            caches["slot"] = self.seq_caches["slot"].init(
                self.cfg, num_slots, max_seq, device)
        return caches

    def serving_step(self, params, caches: Dict[str, Any], tokens, lengths,
                     n_new, block_tables):
        """One engine step: (logits at last valid position, updated caches)."""
        return self._serving_step(params, caches, tokens, lengths, n_new,
                                  block_tables, self.cfg)

    def serving_verify(self, params, caches: Dict[str, Any], tokens, lengths,
                       n_new, block_tables):
        """Logits at every window position (the speculative verify; paged
        families only): ((S, T, padded_vocab), updated caches)."""
        assert self._serving_verify is not None, (
            f"{self.cfg.family}: no serving verify")
        return self._serving_verify(params, caches, tokens, lengths, n_new,
                                    block_tables, self.cfg)

    def encode_prefill(self, params, frames):
        """The encoder pass of one request (CAP_ENCODER): frames (1, enc_seq,
        d) -> its per-slot cross state, (ck, cv) each (L, enc_seq, H, D)."""
        assert self._encode_prefill is not None, (
            f"{self.cfg.family}: no encoder prefill")
        return self._encode_prefill(params, frames, self.cfg)


# --- family adapters ---------------------------------------------------------

def _dense_apply(params, batch, cfg):
    prefix = batch.get("img_embeds")
    logits, aux = transformer.forward(params, batch["tokens"], cfg,
                                      prefix_embeds=prefix)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]   # align logits with text tokens
    return logits, aux


def _dense_serving_step(params, caches, tokens, lengths, n_new, block_tables,
                        cfg):
    logits, pool = transformer.paged_decode_step(
        params, caches["paged"], tokens, lengths, n_new, block_tables, cfg)
    return logits, {"paged": pool}


def _dense_serving_verify(params, caches, tokens, lengths, n_new, block_tables,
                          cfg):
    logits, pool = transformer.paged_verify_step(
        params, caches["paged"], tokens, lengths, n_new, block_tables, cfg)
    return logits, {"paged": pool}


def _apply_of(module):
    def apply(params, batch, cfg):
        return module.forward(params, batch["tokens"], cfg)
    return apply


def _whisper_apply(params, batch, cfg):
    return whisper.forward(params, batch["tokens"], cfg, frames=batch["frames"])


def _decode_of(module):
    def decode(params, cache, batch, cfg):
        return module.decode_step(params, cache, batch["tokens"], batch["pos"], cfg)
    return decode


_TRANSFORMER_SEQ_CACHES = {
    "paged": PagedSeqCache(init=transformer.init_paged_cache,
                           names=transformer.PAGED_CACHE_NAMES),
}

# per family: (param table, apply, decode, init_cache)
_FAMILIES = {
    "dense": (transformer.param_table, _dense_apply, _decode_of(transformer),
              transformer.init_cache),
    "rwkv": (rwkv6.param_table, _apply_of(rwkv6), _decode_of(rwkv6), rwkv6.init_cache),
    "linear_attn": (gla.param_table, _apply_of(gla), _decode_of(gla), gla.init_cache),
    "hybrid": (zamba2.param_table, _apply_of(zamba2), _decode_of(zamba2),
               zamba2.init_cache),
    "audio": (whisper.param_table, _whisper_apply, _decode_of(whisper),
              whisper.init_cache),
}
_FAMILIES["moe"] = _FAMILIES["vlm"] = _FAMILIES["dense"]
# the module of each family's static-path cache
_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer, "rwkv": rwkv6,
            "linear_attn": gla, "hybrid": zamba2, "audio": whisper}

# per family: (seq_caches, serving_step, serving_verify, encode_prefill)
_SERVING = {
    "dense": (_TRANSFORMER_SEQ_CACHES, _dense_serving_step, _dense_serving_verify, None),
    "rwkv": ({"slot": SlotStateCache(init=rwkv6.init_slot_state,
                                     names=rwkv6.SLOT_STATE_NAMES)},
             rwkv6.serving_step, None, None),
    "linear_attn": ({"slot": SlotStateCache(init=gla.init_slot_state,
                                            names=gla.SLOT_STATE_NAMES)},
                    gla.serving_step, None, None),
    # the hybrid threads BOTH caches through one step; its ssm / conv state
    # is not snapshot-swapped (preemption recomputes, like a transformer's)
    "hybrid": ({"paged": PagedSeqCache(init=zamba2.init_paged_cache,
                                       names=zamba2.PAGED_CACHE_NAMES),
                "slot": SlotStateCache(init=zamba2.init_slot_state,
                                       names=zamba2.SLOT_STATE_NAMES, snapshot=False)},
               zamba2.serving_step, None, None),
    # the decoder's self K/V and the encoder's cross K/V, both per slot and
    # snapshot-swapped on preemption; the encoder runs at admission
    "audio": ({"slot": SlotStateCache(init=whisper.init_slot_state,
                                      names=whisper.SLOT_STATE_NAMES)},
              whisper.serving_step, None, whisper.encode_prefill),
}
_SERVING["moe"] = _SERVING["vlm"] = _SERVING["dense"]


def get_model(cfg: Union[ModelConfig, str]) -> Model:
    """Build the uniform Model for a config (or a registered arch-id string)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)   # ValueError naming arch + registered archs
    caps = family_capabilities(cfg.family)   # ValueError on an unknown family
    table_fn, apply_fn, decode_fn, init_cache = _FAMILIES[cfg.family]
    seq_caches, step_fn, verify_fn, encode_fn = _SERVING[cfg.family]
    return Model(cfg, table_fn(cfg), capabilities=caps, seq_caches=dict(seq_caches),
                 _apply=apply_fn, _serving_step=step_fn, _serving_verify=verify_fn,
                 _decode=decode_fn, _init_cache=init_cache, _encode_prefill=encode_fn)


# --- loss ---------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """Masked next-token cross-entropy in f32; padded-vocab logits are
    excluded (set to -1e30)."""
    lf = logits.to(torch.float32)
    if lf.shape[-1] != vocab:
        valid = torch.arange(lf.shape[-1], device=lf.device) < vocab
        lf = torch.where(valid, lf, torch.full((), -1e30, device=lf.device))
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    mask = mask.to(torch.float32)
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
