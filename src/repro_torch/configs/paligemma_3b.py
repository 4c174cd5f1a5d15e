"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
The backbone is the gemma decoder; the port serves it text-only, as the JAX
package's paged step does (the image prefix of precomputed patch embeddings
belongs to the full-sequence forward, not ported yet) [arXiv:2407.07726; hf]"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216, head_dim=256, pad_heads=True,
    n_img_tokens=256, rope_theta=10_000.0,
))
