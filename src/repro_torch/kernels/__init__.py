"""Hand-written Hopper kernels for the LCD serving path.

  csrc/               — CUDA C++ sources (sm_90a), plain C interface
  _build.py           — nvcc build at first launch + ctypes binding
  lut_matmul.py       — fused smooth(+quant)+LUT GEMV / GEMM wrappers
  paged_attention.py  — pool-direct paged attention wrapper
  ops.py              — model-facing dispatch (clustered_linear) + counters
  ref.py              — the plain PyTorch version of every kernel
"""
