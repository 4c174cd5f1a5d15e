"""Hand-written Hopper kernels: the LCD serving path, the §4 LUT layer and
the autotuned attention kernels.

  csrc/               — CUDA C++ sources (sm_90a), plain C interface
  _build.py           — nvcc build at first launch + ctypes binding
  lut_matmul.py       — LUT GEMV / GEMM wrappers: fused smooth(+quant) serving
                        kernels, and the §4 layer's f32 / int8 kernels
  smooth_quant.py     — the standalone Eq. 11 transform wrapper
  paged_attention.py  — paged attention wrappers: pool-direct (B5) and over a
                        gathered int8 view (B8, `paged_dequant_attention`)
  flash_attention.py  — online-softmax attention over (BH, S, D) (B9)
  autotune.py         — measured tile tuner of the attention kernels, keyed
                        on the card, with its persistent JSON cache
  ops.py              — model-facing dispatch (clustered_linear, lut_gemm*) +
                        counters
  ref.py              — the plain PyTorch version of every kernel

The package exports the attention entry points `flash_attention` and
`paged_dequant_attention`. The function `flash_attention` hides its module of
the same name as an attribute of this package, so code that needs the module
itself (its `LAUNCHES`, its `_flash_measure_fn`) imports names from it:
`from repro_torch.kernels.flash_attention import LAUNCHES`.
"""
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402,F401
from repro_torch.kernels.paged_attention import (  # noqa: E402,F401
    paged_dequant_attention, paged_pool_attention)
