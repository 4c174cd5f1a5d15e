"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-12b; hf]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352, head_dim=160,
    norm="layernorm", mlp="swiglu", rope_theta=10_000.0,
))
