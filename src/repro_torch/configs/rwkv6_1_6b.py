"""rwkv6-1.6b [ssm] — Finch: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536, data-dependent decay [arXiv:2404.05892; unverified]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="rwkv6-1.6b", family="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, rwkv_head_dim=64,
))
