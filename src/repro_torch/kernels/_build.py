"""Build and bind the CUDA kernels: nvcc at first use, ctypes to call.

The sources under `csrc/` are compiled for sm_90a, one nvcc per source and all
of them at once, and linked into one shared library with a plain C interface
under `build/repro_torch_kernels/<hash of the sources>/` at the root of the
checkout. Nothing happens at import: `library()` builds (or finds) and loads
it, and the kernel wrappers call it at their first launch. A failed build
raises with nvcc's output; a good one leaves each source's ptxas report
(registers, stack frame and spills per kernel) beside the library, which
`resource_usage()` reads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("lut_gemv.cu", "lut_gemm.cu", "lut_multi_gemv.cu", "lut_multi_gemm.cu",
           "paged_attention.cu", "lut_plain.cu", "smooth_quant.cu", "paged_dequant.cu",
           "flash_attention.cu", "lut_backward.cu")
HEADERS = ("lut_common.cuh", "lut_gemv.cuh", "lut_gemm.cuh", "paged_attention.cuh",
           "cp_async.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build, if it built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of repro_torch cannot be built on this machine")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> List[str]:
    """Start every command at once, wait for all, raise on the first failure
    with the compiler's output; returns each command's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed, outs = None, []
    for cmd, p in procs:
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode != 0 and failed is None:
            failed = (cmd, p.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(
            f"kernel build failed (exit {rc}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> Path:
    """Compile the sources if this hash has not been built; returns the path
    of the shared library."""
    global build_seconds
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    objs = [out_dir / (Path(s).stem + ".o") for s in SOURCES]
    outs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                     for s, o in zip(SOURCES, objs)])
    for o, out in zip(objs, outs):
        o.with_suffix(".ptxas.txt").write_text(out)
    tmp = out_dir / f".{lib_path.name}.{os.getpid()}"
    _run_all([[nvcc, "-shared", *NVCC_FLAGS, *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, lib_path)          # atomic: a concurrent reader never sees half a file
    build_seconds = time.perf_counter() - t0
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.lut_gemv_launch
    # x, x_is_bf16, inv, packed, cb, y, M, K, N, packed_rows, nbits, quantize, stream
    fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.lut_gemv_plan
    # M, K, P, widths[P], nbits[P], quantize[P] (host int arrays), x_bytes,
    # sms, out[7] (rows a block, strips, row blocks, units, stages a unit,
    # grid, uniform) -> shared-memory bytes, or -1 where the launchers refuse
    fn.argtypes = [i, i, i, p, p, p, i, i, ctypes.POINTER(i)]
    fn.restype = i
    fn = lib.lut_gemm_launch
    # lut_gemv_launch's arguments, then the scratch xt before the stream
    fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, p, p]
    fn.restype = i
    fn = lib.lut_gemm_scratch_floats
    # M, K -> floats of the GEMM's scratch per operand set
    fn.argtypes = [i, i]
    fn.restype = ctypes.c_longlong
    fn = lib.lut_multi_gemv_launch
    # x, x_is_bf16, inv_stack, cb_stack, packed[P] (host array of pointers),
    # widths[P], nbits[P], quantize[P] (host int arrays), P, y, M, K, stream
    fn.argtypes = [p, i, p, p, p, p, p, p, i, p, i, i, p]
    fn.restype = i
    fn = lib.lut_multi_gemm_launch
    # the same, then the scratch xt (P operand sets) before the stream
    fn.argtypes = [p, i, p, p, p, p, p, p, i, p, i, i, p, p]
    fn.restype = i
    fn = lib.lut_f32_launch
    # x, x_is_bf16, packed, cb, y, M, K, N, packed_rows, nbits, xt, stream
    fn.argtypes = [p, i, p, p, p, i, i, i, i, i, p, p]
    fn.restype = i
    fn = lib.lut_int8_launch
    # q, packed, cb, s_q, y, M, K, N, packed_rows, nbits, xt, stream
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p]
    fn.restype = i
    fn = lib.split_bf16_launch
    # x, smooth (or null), hi, lo, rows, cols, stream
    fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, p]
    fn.restype = i
    fn = lib.lut_matmul_t_launch
    # dy_hi, dy_lo, packed, cb, dxs, M, K, N, packed_rows, nbits, stream
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.lut_codebook_grad_scratch_floats
    # K, N -> floats of lut_codebook_grad_launch's scratch
    fn.argtypes = [i, i]
    fn.restype = ctypes.c_longlong
    fn = lib.lut_codebook_grad_launch
    # xs_hi, xs_lo, dy_hi, dy_lo, packed, cb, smooth, dcb, dsmooth, scratch,
    # M, K, N, packed_rows, nbits, stream
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.smooth_quant_launch
    # x, x_is_bf16, inv, q, M, C, bits, stream
    fn.argtypes = [p, i, p, p, ctypes.c_longlong, i, i, p]
    fn.restype = i
    fn = lib.paged_attn_launch
    # q, q_is_bf16, k_pool, v_pool, pool_kind, k_scale, v_scale, k_smooth,
    # v_smooth, block_tables, lengths, n_new, out, S, T, H, KV, D, nb, bs, NB,
    # window, softcap, rows, stage_keys (pool_plan), stream
    fn.argtypes = [p, i, p, p, i, p, p, p, p, p, p, p, p,
                   i, i, i, i, i, i, i, i, i, f, i, i, p]
    fn.restype = i
    fn = lib.paged_attn_plan
    # rows, stage_keys, D, pool_kind, geom (4 ints out: rg, groups, split,
    # row_bytes) -> shared-memory bytes, or -1 where the plan is refused
    fn.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    fn.restype = ctypes.c_longlong
    fn = lib.paged_dequant_launch
    # q, q_is_bf16, kq, k_scale, vq, v_scale, k_smooth, v_smooth, lengths,
    # n_new, window_ptr (or null), window, out, S, T, H, KV, D, L, rows, l_pad
    # (pool_plan), softcap, stream
    fn.argtypes = [p, i, p, p, p, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, i, f, p]
    fn.restype = i
    fn = lib.flash_attn_launch
    # q, k, v, out, is_bf16, BH, Sq, Sk, D, bq, bk, causal, window, softcap,
    # q_offset, k_len, stream
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, i, p]
    fn.restype = i


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def resource_usage(build_dir: Optional[Path] = None) -> Dict[str, Dict]:
    """Per kernel (template instances pooled by kernel name): the range of
    registers per thread and the largest stack frame and spill bytes, from
    the ptxas reports of the build in `build_dir` (default: the current
    sources' build)."""
    out: Dict[str, Dict] = {}
    name = None
    for f in sorted((build_dir or BUILD_ROOT / _source_hash()).glob("*.ptxas.txt")):
        for line in f.read_text().splitlines():
            # mangled: ...<length><name>_kernel<template args>
            m = re.search(r"Compiling entry function '\S*?\d([a-z_]+_kernel)", line)
            if m:
                name = m.group(1)
                continue
            if name is None:
                continue
            k = out.setdefault(name, {"registers": [], "stack_bytes": 0, "spill_bytes": 0})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                stack, st, ld = map(int, m.groups())
                k["stack_bytes"] = max(k["stack_bytes"], stack)
                k["spill_bytes"] = max(k["spill_bytes"], st + ld)
            m = re.search(r"Used (\d+) registers", line)
            if m:
                k["registers"].append(int(m.group(1)))
    return {n: {**k, "registers": [min(k["registers"]), max(k["registers"])]}
            for n, k in out.items() if k["registers"]}


def check_launch(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
