"""GLA 1.3B — gated linear attention (arXiv:2312.06635)."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="gla-1.3b",
    family="linear_attn",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=32000,
    rwkv_head_dim=64,
))
