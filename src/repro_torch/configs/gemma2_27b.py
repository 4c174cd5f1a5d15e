"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Alternating local/global attention + logit softcapping [arXiv:2408.00118; hf]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab=256000, head_dim=128,
    norm="rmsnorm", mlp="swiglu", rope_theta=10_000.0,
    attn_softcap=50.0, final_softcap=30.0,
    local_window=4096, layer_pattern="alt_local_global",
))
