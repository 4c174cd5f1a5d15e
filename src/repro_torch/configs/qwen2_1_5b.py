"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
GQA + QKV bias [arXiv:2407.10671; hf]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128, pad_heads=True,
    norm="rmsnorm", mlp="swiglu", qkv_bias=True, rope_theta=1_000_000.0,
))
