"""llama2-7b — the paper's own evaluation subject (Table 1/2): 32L d_model=4096
32H MHA d_ff=11008 vocab=32000 [arXiv:2307.09288]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=32000, head_dim=128,
    rope_theta=10_000.0,
))
