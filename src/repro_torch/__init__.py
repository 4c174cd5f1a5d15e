"""repro_torch — the PyTorch/CUDA port of the LCD system (compression and serving).

Same sub-layout and function names as the JAX package `repro` beside it, so
the counterpart of a module is found by path. The package imports `torch`,
`numpy` and the standard library only; its kernels are CUDA C++ sources under
`kernels/csrc/`, compiled at first launch (never at import).
"""
__version__ = "0.1.0"
