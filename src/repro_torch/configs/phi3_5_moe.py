"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064, head_dim=128,
    n_experts=16, moe_topk=2, rope_theta=10_000.0,
))
