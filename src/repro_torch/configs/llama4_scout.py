"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Simplification, as in the JAX package: routed-only 16-expert top-1 MoE (the
released model adds a shared expert; the assigned config specifies 16e
top-1)."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128, pad_heads=True,
    n_experts=16, moe_topk=1, rope_theta=500_000.0,
))
