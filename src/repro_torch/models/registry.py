"""Model registry: one uniform interface over the ported architecture families.

    model = get_model(cfg)                      # cfg or arch-id string
    params = model.init(generator, device)      # real tensors
    logits, caches = model.serving_step(params, caches, tokens, lengths,
                                        n_new, block_tables)
    logits, caches = model.serving_verify(params, caches, tokens, lengths,
                                          n_new, block_tables)   # every position
    cache = model.init_cache(batch, max_seq, device)          # static path
    logits, cache = model.decode(params, cache, {"tokens": t, "pos": cache["pos"]})

Serving surface (launch/engine.py): a family publishes the sequence caches it
serves through, keyed by kind ("paged": a block-table pool over
(num_blocks, block_size) rows), plus a capability set telling the engine which
features apply. The dense family and the vlm family are ported; a vlm arch
(paligemma-3b) serves its text decoder through the dense paged step, as the
JAX package's does (its image prefix belongs to the full-sequence forward,
which is not ported yet).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.models import params as PT
from repro_torch.models import transformer
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

# the capability sets of every family the JAX package serves; EngineConfig
# validates against them even where the family itself is not ported yet
FAMILY_CAPS: Dict[str, frozenset] = {
    "dense": _TRANSFORMER_CAPS,
    "moe": _TRANSFORMER_CAPS,
    "vlm": _TRANSFORMER_CAPS,
    "rwkv": _RECURRENT_CAPS,
    "linear_attn": _RECURRENT_CAPS,
    "hybrid": frozenset({CAP_PAGED, CAP_SLOT_STATE}),
    "audio": frozenset({CAP_SLOT_STATE, CAP_SNAPSHOT, CAP_ENCODER}),
}

PORTED_FAMILIES = ("dense", "vlm")


def family_capabilities(family: str) -> frozenset:
    if family not in FAMILY_CAPS:
        raise ValueError(
            f"unknown model family {family!r}; registered families: "
            f"{', '.join(sorted(FAMILY_CAPS))}")
    return FAMILY_CAPS[family]


def arch_capabilities(arch_id: str) -> frozenset:
    """Capability set for a registered arch id (ValueError when unknown)."""
    return family_capabilities(get_config(arch_id).family)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    table: PT.Table
    capabilities: frozenset = frozenset()
    _init_paged_cache: Optional[Callable] = None
    _serving_step: Optional[Callable] = None
    _serving_verify: Optional[Callable] = None
    _decode: Optional[Callable] = None
    _init_cache: Optional[Callable] = None

    def init(self, generator: torch.Generator, device="cuda"):
        return PT.init_params(generator, self.table, self.cfg.torch_dtype,
                              device)

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
        return {"paged": self._init_paged_cache(
            self.cfg, num_blocks, block_size, kv_dtype, device)}

    def serving_step(self, params, caches: Dict[str, Any], tokens, lengths,
                     n_new, block_tables):
        """One engine step: (logits at last valid position, updated caches)."""
        return self._serving_step(params, caches, tokens, lengths, n_new,
                                  block_tables, self.cfg)

    def serving_verify(self, params, caches: Dict[str, Any], tokens, lengths,
                       n_new, block_tables):
        """Logits at every window position (the speculative verify; paged
        families only): ((S, T, padded_vocab), updated caches)."""
        return self._serving_verify(params, caches, tokens, lengths, n_new,
                                    block_tables, self.cfg)


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


def _dense_decode(params, cache, batch, cfg):
    return transformer.decode_step(params, cache, batch["tokens"], batch["pos"], cfg)


def get_model(cfg: Union[ModelConfig, str]) -> Model:
    """Build the uniform Model for a config (or a registered arch-id string)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)   # ValueError naming arch + registered archs
    caps = family_capabilities(cfg.family)   # ValueError on an unknown family
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} (arch {cfg.arch_id!r}) is not ported "
            f"yet; ported families: {', '.join(PORTED_FAMILIES)}")
    return Model(cfg, transformer.param_table(cfg), capabilities=caps,
                 _init_paged_cache=transformer.init_paged_cache,
                 _serving_step=_dense_serving_step,
                 _serving_verify=_dense_serving_verify, _decode=_dense_decode,
                 _init_cache=transformer.init_cache)
