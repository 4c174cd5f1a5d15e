"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64; Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    attn_period=6,
))
