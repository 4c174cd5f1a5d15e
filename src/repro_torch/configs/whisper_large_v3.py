"""whisper-large-v3 [audio] — enc-dec, 32L(+32 enc) d_model=1280 20H (MHA)
d_ff=5120 vocab=51866; conv frontend is a STUB (precomputed frames)
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64, pad_heads=True,
    norm="layernorm", mlp="gelu",
    n_enc_layers=32, enc_seq=1500,
))
