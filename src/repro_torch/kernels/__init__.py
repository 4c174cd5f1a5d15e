"""Hand-written Hopper kernels for the LCD serving path and the §4 LUT layer.

  csrc/               — CUDA C++ sources (sm_90a), plain C interface
  _build.py           — nvcc build at first launch + ctypes binding
  lut_matmul.py       — LUT GEMV / GEMM wrappers: fused smooth(+quant) serving
                        kernels, and the §4 layer's f32 / int8 kernels
  smooth_quant.py     — the standalone Eq. 11 transform wrapper
  paged_attention.py  — pool-direct paged attention wrapper
  ops.py              — model-facing dispatch (clustered_linear, lut_gemm*) +
                        counters
  ref.py              — the plain PyTorch version of every kernel
"""
