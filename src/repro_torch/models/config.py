"""Model configuration system.

One `ModelConfig` describes every architecture; family-specific fields are
simply unused by other families. Configs for the served architectures live in
repro_torch/configs/<id>.py and are registered by name. The fields, defaults
and derived widths are those of the JAX package's `ModelConfig`, so a config
carries across unchanged.

Conventions
-----------
* weight matrices are (d_in, d_out);
* vocab is padded up to a multiple of `VOCAB_PAD` (4096); logits beyond
  `vocab` are never sampled;
* `head_dim` is explicit (gemma2-style configs decouple it from d_model).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.utils import round_up

VOCAB_PAD = 4096

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | rwkv | linear_attn |
                                    # hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    qkv_bias: bool = False          # qwen2
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0       # gemma2 logit softcapping (attention)
    final_softcap: float = 0.0      # gemma2 logit softcapping (final logits)
    local_window: int = 0           # gemma2 sliding window (alternating layers)
    layer_pattern: str = "global"   # global | alt_local_global
    mlp: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    pad_heads: bool = False         # pad q-heads up to a multiple of 16
                                    # (zero-weight heads are exact no-ops
                                    # through W_o)
    # MoE
    n_experts: int = 0
    moe_topk: int = 0
    # SSM / RWKV / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_period: int = 0
    ssm_impl: str = "chunked"
    rwkv_head_dim: int = 64
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0
    # vlm
    n_img_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"
    kv_cache_dtype: str = "bf16"    # bf16 | int8
    fused_projections: bool = True  # fuse same-input clustered projections
                                    # (QKV; gate+up) into one multi-output LUT
                                    # launch; bit-equal to the unfused path

    # ---- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab, VOCAB_PAD)

    @property
    def n_heads_eff(self) -> int:
        if not self.pad_heads:
            return self.n_heads
        he = round_up(self.n_heads, 16)
        if self.n_kv_heads == self.n_heads:
            return he      # MHA: kv heads pad along with q
        # GQA grouping needs KV | He
        while he % self.n_kv_heads:
            he += 1
        return he

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def q_dim_eff(self) -> int:
        return self.n_heads_eff * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def d_inner(self) -> int:       # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    # ---- parameter counting (the JAX package's closed form) -----------------
    def param_count(self, active_only: bool = False) -> int:
        """Parameters by the JAX package's closed form (its roofline's N):
        the projections, the recurrent families' LoRA adapters and mixers,
        the hybrid's one shared attention + MLP block, embeddings and head.
        `Model.param_count` counts the parameter table instead."""
        d, f = self.d_model, self.d_ff
        qd, kvd = self.q_dim, self.kv_dim
        attn = d * qd + 2 * d * kvd + qd * d
        if self.family == "rwkv":
            # r, k, v, g, o projections + decay LoRA + channel mix
            per = 4 * d * d + d * d + 2 * d * 64 + d * f + f * d
            body = self.n_layers * per
        elif self.family == "linear_attn":
            # q, k, v, o projections + gate LoRA + gelu MLP
            per = 4 * d * d + 2 * d * 64 + 2 * d * f
            body = self.n_layers * per
        elif self.family == "hybrid":
            di, ns = self.d_inner, self.ssm_state
            per = d * (2 * di + 2 * ns + self.ssm_heads) + di * d
            body = self.n_layers * per + attn + 2 * d * f   # one shared block
        else:
            mlp_mult = 3 if self.mlp == "swiglu" else 2
            if self.n_experts:
                mlp = self.n_experts * mlp_mult * d * f + d * self.n_experts
                mlp_active = self.moe_topk * mlp_mult * d * f
            else:
                mlp = mlp_active = mlp_mult * d * f
            body = self.n_layers * (attn + (mlp_active if active_only else mlp))
            if self.is_encdec:
                # encoder self-attention + MLP; the decoder's cross-attention
                body += self.n_enc_layers * (attn + mlp_mult * d * f)
                body += self.n_layers * attn
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return int(body + emb)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        _load_all()
    if arch_id not in _REGISTRY:
        raise ValueError(
            f"unknown arch {arch_id!r}; registered archs: "
            f"{', '.join(list_archs())}")
    return _REGISTRY[arch_id]


def list_archs() -> list:
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    import importlib
    import pkgutil

    import repro_torch.configs as cpkg

    for m in pkgutil.iter_modules(cpkg.__path__):
        importlib.import_module(f"repro_torch.configs.{m.name}")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test configuration: same family/wiring, tiny dimensions."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.attn_period == 0 else 2 * cfg.attn_period),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_topk=min(cfg.moe_topk, 2) if cfg.moe_topk else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        rwkv_head_dim=32,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=32 if cfg.enc_seq else 0,
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        local_window=min(cfg.local_window, 16) if cfg.local_window else 0,
        attn_period=min(cfg.attn_period, 2) if cfg.attn_period else 0,
        dtype="float32",
        arch_id=cfg.arch_id + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
