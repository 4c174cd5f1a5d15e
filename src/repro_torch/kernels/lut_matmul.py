"""Sub-byte-code dequant + matmul — the LCD LUT GEMMs, for Hopper.

Six entry points, the counterparts of the JAX package's Pallas kernels of
the same names:

  lut_matmul_f32              — Y = x @ codebook[codes], x already smoothed;
  lut_matmul_int8             — Y = s_q * (q @ codebook[codes]), q the int8
                                Eq. 11 codes (the paper's §4 bucket
                                accumulation);

  lut_matmul_fused            — Y = T(x) @ codebook[codes], any M (used for
                                M >= 128);
  lut_matmul_fused_gemv       — the same contraction for decode, M < 128;
  lut_matmul_fused_multi      — P projections sharing x (QKV; gate+up), their
                                outputs concatenated along N, in one launch;
  lut_matmul_fused_multi_gemv — the same for decode, M < 128.

T is the Eq. 11 input transform: x · inv_scale, and when `quantize`
clip(round(·), ±127) with round-half-to-even. The caller applies the trailing
s_q rescale. Weights arrive as packed centroid codes at `nbits` in {2, 3, 4}
per code (core/lut.py layout); the codebook is padded to KC entries.

On a CUDA tensor a wrapper launches its kernel (kernels/csrc/lut_plain.cu,
lut_gemv.cu, lut_gemm.cu, lut_multi_gemv.cu, lut_multi_gemm.cu) on the
current stream and counts the launch; on a CPU tensor it runs the plain version (kernels/ref.py).
The GEMM's launches (B2, B4, and B6 / B7 from 128 rows on) take a scratch
the wrapper allocates, into which their pre-pass writes the transformed
activations once.
The kernels take the true M and N and mask ragged edges themselves; K must be
the packing-group-padded d_in. All six sum over K in one fixed order, so a
row's result is the same bits from any of them (lut_matmul_int8 on q equals
lut_matmul_fused on x times s_q wherever q = clip(round(x * inv), ±127)), and
a projection's segment of a multi launch the same bits as its solo launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.lut import SUPPORTED_NBITS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (lut_matmul_f32_ref,
                                     lut_matmul_fused_multi_ref,
                                     lut_matmul_fused_ref, lut_matmul_int8_ref)

# Codebook capacity the kernels are specialized for: <= 4-bit codes. Codebooks
# are always padded to KC entries; an nbits-wide tensor references the first
# 2^nbits of them.
KC = 16

# launches of each kernel since the last reset (plain ints; see kernels/ops.py)
LAUNCHES = {"lut_matmul_fused_gemv": 0, "lut_matmul_fused": 0,
            "lut_matmul_fused_multi_gemv": 0, "lut_matmul_fused_multi": 0,
            "lut_matmul_f32": 0, "lut_matmul_int8": 0}

# projections one multi launch takes (the kernels' descriptor capacity,
# csrc/lut_common.cuh MAX_PROJ)
MAX_PROJ = 8

# the GEMV body's constants (csrc/lut_gemv.cuh)
_WAYS, _KB = 64, 8      # the canonical K order: 64 ways of 8-channel k-blocks
_GEMV_COLS = 32         # columns of a strip
_GEMV_THREADS = 384     # 256 consumers (way, 8-column group), 128 producers
_GEMV_MAX_M = 127
_MAX_SMEM = 232448      # bytes of shared memory one thread block may use


def _gemv_smem(nbits: int, mt: int, x_bytes: int) -> int:
    """Bytes of one block (csrc/lut_gemv.cuh Layout): the decode table (a
    byte-indexed float2 / float4 table in 16 / 8 copies, or 8 codebook
    entries in 32 at 3 bits); the ring, 4 entries (3 with f32 activations)
    of a stage's packed code rows, raw x rows and inv; each consumer warp's
    two T(x) tiles; the fold buffer; the ring's mbarriers."""
    ring = 3 if x_bytes == 4 else 4
    table = (8 if nbits == 3 else 256) * 128
    entry = _WAYS * nbits * _GEMV_COLS + mt * _WAYS * _KB * x_bytes + _WAYS * _KB * 4
    tiles = 2 * 4 * _WAYS * (_KB * mt + 4)
    return table + ring * entry + tiles + 4 * _WAYS * mt * _GEMV_COLS + 2 * ring * 8


def gemv_plan(m: int, k: int, widths, nbits, quantize, *, x_bytes: int = 2, sms: int = 132,
              name: str = "lut_matmul_fused_multi_gemv") -> dict:
    """The geometry the GEMV launchers (B1, B3, and B6 / B7 below 128 rows)
    give an (m, k) launch over the projections `widths`, with activations of
    `x_bytes` bytes (4 f32, 2 bf16, 1 int8), on a card of `sms` SMs, the same
    arithmetic as csrc/lut_gemv.cuh make_plan; raises ValueError for what
    they refuse.

    The output is cut into units: a strip of 32 columns of one projection
    (projection p's strips after those of p - 1, so none straddles two) by
    a block of `rows_per_block` rows, 4 when m <= 4 and every projection has
    the same width and quantize flag (`uniform`), else 8. A uniform launch
    runs one instance compiled for that width and flag on a persistent grid
    of min(units, sms) blocks; a mixed one gives each unit its own block.
    No choice here moves a bit of the result: the canonical K order fixes
    each output's arithmetic."""
    widths, nbits = [int(w) for w in widths], [int(b) for b in nbits]
    quantize = [bool(q) for q in quantize]
    p = len(widths)
    if not 1 <= p <= MAX_PROJ or len(nbits) != p or len(quantize) != p:
        raise ValueError(f"{name}: 1 to {MAX_PROJ} projections, each with a width, nbits and "
                         f"quantize flag; got widths {widths}, nbits {nbits}, "
                         f"quantize {quantize}")
    if not 1 <= m <= _GEMV_MAX_M or k < 1 or sms < 1 or x_bytes not in (4, 2, 1):
        raise ValueError(f"{name}: the GEMV takes 1 <= M <= {_GEMV_MAX_M}, K >= 1 and "
                         f"activations of 4, 2 or 1 bytes; got M {m}, K {k}, {x_bytes} bytes "
                         f"(SMs {sms})")
    for w, b in zip(widths, nbits):
        if w < 1 or b not in SUPPORTED_NBITS or (k * b) % 8:
            raise ValueError(f"{name}: a projection {w} wide at {b} bits over K {k}: widths "
                             f"must be >= 1, nbits one of {SUPPORTED_NBITS}, K * nbits a "
                             f"multiple of 8")
    uniform = len(set(nbits)) == 1 and len(set(quantize)) == 1
    mt = 4 if uniform and m <= 4 else 8
    smem = max(_gemv_smem(b, mt, x_bytes) for b in nbits)
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: {smem} bytes of shared memory; a block holds at most "
                         f"{_MAX_SMEM}")
    strip0 = [0]
    for w in widths:
        strip0.append(strip0[-1] + -(-w // _GEMV_COLS))
    mblocks = -(-m // mt)
    units = strip0[-1] * mblocks
    kblocks = -(-k // _KB)
    return dict(m=m, k=k, widths=tuple(widths), rows_per_block=mt, cols_per_strip=_GEMV_COLS,
                threads=_GEMV_THREADS, ring_stages=3 if x_bytes == 4 else 4,
                strip0=tuple(strip0),
                strips=strip0[-1], row_blocks=mblocks, units=units,
                stages_per_unit=-(-kblocks // _WAYS),
                grid=min(units, sms) if uniform else units, uniform=uniform, smem_bytes=smem)


def _check_packed_shape(k: int, packed_shape, nbits: int, caller: str) -> None:
    """Explicit shape validation for the packed-code operand, naming the
    packing width and the offending shapes, so a 2-bit tensor routed through a
    4-bit call site fails loudly instead of streaming garbage codes."""
    if nbits not in SUPPORTED_NBITS:
        raise ValueError(
            f"{caller}: nbits must be one of {SUPPORTED_NBITS}; got {nbits}")
    k2 = packed_shape[0]
    if k2 * 8 != k * nbits:
        raise ValueError(
            f"{caller}: packed codes have {k2} rows but K={k} at "
            f"{nbits}-bit packing needs K*nbits/8 = {k * nbits / 8:g} "
            f"(packed shape {tuple(packed_shape)}); did the activation and "
            f"the packed tensor disagree on the packing width?")


def _check_operands(x, inv_scale, packed_codes, codebook, nbits, caller,
                    x_dtypes=(torch.float32, torch.bfloat16)):
    """Shapes, dtypes, devices and contiguity; `inv_scale` is None for the
    kernels without an input transform."""
    if x.ndim != 2 or packed_codes.ndim != 2:
        raise ValueError(f"{caller}: x and packed_codes must be 2-D; got "
                         f"{tuple(x.shape)} and {tuple(packed_codes.shape)}")
    m, k = x.shape
    _check_packed_shape(k, packed_codes.shape, nbits, caller)
    if inv_scale is not None and tuple(inv_scale.shape) != (k,):
        raise ValueError(f"inv_scale must be ({k},); got {tuple(inv_scale.shape)}")
    if tuple(codebook.shape) != (KC,):
        raise ValueError(f"codebook must be padded to ({KC},); got "
                         f"{tuple(codebook.shape)}")
    if x.dtype not in x_dtypes:
        names = " or ".join(str(d).split(".")[-1] for d in x_dtypes)
        raise TypeError(f"{caller}: x must be {names}; got {x.dtype}")
    if packed_codes.dtype != torch.uint8:
        raise TypeError(f"{caller}: packed_codes must be uint8; got "
                        f"{packed_codes.dtype}")
    named = [("x", x), ("packed_codes", packed_codes), ("codebook", codebook)]
    if inv_scale is not None:
        named.append(("inv_scale", inv_scale))
    for name, t in named[2:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{caller}: {name} must be float32; got {t.dtype}")
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{caller}: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be contiguous; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


def _scratch(m: int, k: int, sets: int, device):
    """The GEMM's scratch for `sets` operand sets of an (m, k) launch: the
    transformed activations, which its pre-pass writes once and its tiles
    read (csrc/lut_gemm.cuh)."""
    floats = _build.library().lut_gemm_scratch_floats(m, k)
    return torch.empty((sets * floats,), dtype=torch.float32, device=device)


def _launch(name: str, c_name: str, x, inv_scale, packed_codes, codebook,
            quantize, nbits):
    m, k = x.shape
    n = packed_codes.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _build.library()
    fn = getattr(lib, c_name)
    # the GEMM takes its scratch before the stream; the GEMV takes none
    scratch = _scratch(m, k, 1, x.device) if c_name == "lut_gemm_launch" else None
    extra = () if scratch is None else (scratch.data_ptr(),)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 inv_scale.data_ptr(), packed_codes.data_ptr(),
                 codebook.data_ptr(), y.data_ptr(), m, k, n,
                 packed_codes.shape[0], nbits, int(bool(quantize)), *extra,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)
    LAUNCHES[name] += 1
    return y


def lut_matmul_fused(
    x: torch.Tensor,            # (M, K) float — RAW activations (not smoothed)
    inv_scale: torch.Tensor,    # (K,) f32 = 1/(s_m·s_q) (quantize) or 1/s_m
    packed_codes: torch.Tensor, # (K*nbits//8, N) uint8 — packed centroid codes
    codebook: torch.Tensor,     # (KC,) f32 — padded with zeros beyond the active K
    *,
    quantize: bool = True,
    nbits: int = 4,
) -> torch.Tensor:
    """Y = transform(x) @ codebook[codes] in f32, the transform fused into the
    K loop; no intermediate activation tensor in device memory."""
    _check_operands(x, inv_scale, packed_codes, codebook, nbits,
                    "lut_matmul_fused")
    if x.device.type != "cuda":
        return lut_matmul_fused_ref(x, inv_scale, packed_codes, codebook, 1.0,
                                    quantize=quantize, nbits=nbits)
    return _launch("lut_matmul_fused", "lut_gemm_launch", x, inv_scale,
                   packed_codes, codebook, quantize, nbits)


def lut_matmul_fused_gemv(
    x: torch.Tensor,            # (M, K), M < 128 (decode micro-batch)
    inv_scale: torch.Tensor,    # (K,) f32
    packed_codes: torch.Tensor, # (K*nbits//8, N) uint8
    codebook: torch.Tensor,     # (KC,) f32
    *,
    quantize: bool = True,
    nbits: int = 4,
) -> torch.Tensor:
    """Decode-specialized fused GEMV: the packed codes are the only operand
    of size, read once; K is split inside each thread block so that a few
    rows of M still fill the card."""
    if x.ndim == 2 and x.shape[0] >= 128:
        raise ValueError(
            f"lut_matmul_fused_gemv: M ({x.shape[0]}) must be < 128")
    _check_operands(x, inv_scale, packed_codes, codebook, nbits,
                    "lut_matmul_fused_gemv")
    if x.device.type != "cuda":
        return lut_matmul_fused_ref(x, inv_scale, packed_codes, codebook, 1.0,
                                    quantize=quantize, nbits=nbits)
    return _launch("lut_matmul_fused_gemv", "lut_gemv_launch", x, inv_scale,
                   packed_codes, codebook, quantize, nbits)


# ---------------------------------------------------------------------------
# The paper's §4 layer: activations that need no transform
# ---------------------------------------------------------------------------

def lut_matmul_f32(
    x: torch.Tensor,            # (M, K) float (bf16/f32) — pre-smoothed activations
    packed_codes: torch.Tensor, # (K*nbits//8, N) uint8 — packed centroid codes
    codebook: torch.Tensor,     # (KC,) f32 — padded with zeros beyond the active K
    *,
    nbits: int = 4,
) -> torch.Tensor:
    """Y = x @ codebook[codes] in f32, codes streamed packed at `nbits`/code."""
    _check_operands(x, None, packed_codes, codebook, nbits, "lut_matmul_f32")
    if x.device.type != "cuda":
        return lut_matmul_f32_ref(x, packed_codes, codebook, nbits=nbits)
    m, k = x.shape
    n = packed_codes.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    scratch = _scratch(m, k, 1, x.device) if m >= 128 else None
    xt = None if scratch is None else scratch.data_ptr()
    with torch.cuda.device(x.device):
        err = _build.library().lut_f32_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), packed_codes.data_ptr(),
            codebook.data_ptr(), y.data_ptr(), m, k, n, packed_codes.shape[0], nbits, xt,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "lut_matmul_f32")
    LAUNCHES["lut_matmul_f32"] += 1
    return y


def lut_matmul_int8(
    q: torch.Tensor,            # (M, K) int8 — Eq. 11 activation indices
    packed_codes: torch.Tensor, # (K*nbits//8, N) uint8
    codebook: torch.Tensor,     # (KC,) f32 centroids of the smoothed weights
    act_scale,                  # s_q: a one-element f32 tensor, or a float
    *,
    nbits: int = 4,
) -> torch.Tensor:
    """Y = s_q * (q @ codebook[codes]) — the paper's bucket accumulation, in
    f32; the kernel applies s_q in its epilogue."""
    _check_operands(q, None, packed_codes, codebook, nbits, "lut_matmul_int8",
                    x_dtypes=(torch.int8,))
    act = torch.as_tensor(act_scale, dtype=torch.float32, device=q.device).reshape(())
    if q.device.type != "cuda":
        return lut_matmul_int8_ref(q, packed_codes, codebook, act, nbits=nbits)
    m, k = q.shape
    n = packed_codes.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=q.device)
    scratch = _scratch(m, k, 1, q.device) if m >= 128 else None
    xt = None if scratch is None else scratch.data_ptr()
    with torch.cuda.device(q.device):
        err = _build.library().lut_int8_launch(
            q.data_ptr(), packed_codes.data_ptr(), codebook.data_ptr(),
            act.data_ptr(), y.data_ptr(), m, k, n, packed_codes.shape[0],
            nbits, xt, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "lut_matmul_int8")
    LAUNCHES["lut_matmul_int8"] += 1
    return y


# ---------------------------------------------------------------------------
# Multi-projection kernels (QKV, gate+up share one input)
# ---------------------------------------------------------------------------

def _check_multi(x, inv_stack, cb_stack, packed_list, quantize, nbits, caller):
    """The reference's `_check_multi` errors, without its tile-width ones
    (the kernels take the true widths), plus the operand checks of the solo
    wrappers and the descriptor capacity."""
    if x.ndim != 2:
        raise ValueError(f"{caller}: x must be 2-D; got {tuple(x.shape)}")
    m, k = x.shape
    n_proj = len(packed_list)
    widths = tuple(int(pk.shape[1]) if pk.ndim == 2 else -1 for pk in packed_list)
    if not (len(quantize) == len(nbits) == n_proj > 0):
        raise ValueError(
            f"{caller}: {n_proj} packed operands but widths={widths}, "
            f"quantize={quantize}, nbits={nbits}")
    if n_proj > MAX_PROJ:
        raise ValueError(
            f"{caller}: {n_proj} projections; one launch takes at most "
            f"{MAX_PROJ}")
    if tuple(inv_stack.shape) != (n_proj, k):
        raise ValueError(f"{caller}: inv_stack must be ({n_proj}, {k}); got "
                         f"{tuple(inv_stack.shape)}")
    if tuple(cb_stack.shape) != (n_proj, KC):
        raise ValueError(f"{caller}: cb_stack must be ({n_proj}, {KC}); got "
                         f"{tuple(cb_stack.shape)}")
    for p, pk in enumerate(packed_list):
        if pk.ndim != 2:
            raise ValueError(f"{caller}: projection {p} packed codes must be "
                             f"2-D; got {tuple(pk.shape)}")
        _check_packed_shape(k, pk.shape, nbits[p], caller)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{caller}: x must be float32 or bfloat16; got {x.dtype}")
    for name, t in (("inv_stack", inv_stack), ("cb_stack", cb_stack)):
        if t.dtype != torch.float32:
            raise TypeError(f"{caller}: {name} must be float32; got {t.dtype}")
    tensors = [("x", x), ("inv_stack", inv_stack), ("cb_stack", cb_stack)]
    for p, pk in enumerate(packed_list):
        if pk.dtype != torch.uint8:
            raise TypeError(f"{caller}: packed codes of projection {p} must be "
                            f"uint8; got {pk.dtype}")
        tensors.append((f"packed codes of projection {p}", pk))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{caller}: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{caller}: {name} must be contiguous; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


def _multi(name, c_name, x, inv_stack, cb_stack, packed_list, quantize, nbits):
    """Check, then the plain version (CPU tensors) or the kernel (CUDA)."""
    quantize, nbits = tuple(quantize), tuple(nbits)
    _check_multi(x, inv_stack, cb_stack, packed_list, quantize, nbits, name)
    if x.device.type != "cuda":
        return torch.cat(lut_matmul_fused_multi_ref(
            x, inv_stack, packed_list, cb_stack, [1.0] * len(packed_list),
            quantize=quantize, nbits=nbits), dim=1)
    m, k = x.shape
    n_proj = len(packed_list)
    widths = [int(pk.shape[1]) for pk in packed_list]
    y = torch.empty((m, sum(widths)), dtype=torch.float32, device=x.device)

    def ints(v):
        return (ctypes.c_int * n_proj)(*v)

    fn = getattr(_build.library(), c_name)
    # the GEMM takes its scratch (one operand set per projection) before the stream
    scratch = _scratch(m, k, n_proj, x.device) if c_name == "lut_multi_gemm_launch" else None
    extra = () if scratch is None else (scratch.data_ptr(),)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 inv_stack.data_ptr(), cb_stack.data_ptr(),
                 (ctypes.c_void_p * n_proj)(*[pk.data_ptr() for pk in packed_list]),
                 ints(widths), ints(nbits), ints([int(bool(q)) for q in quantize]),
                 n_proj, y.data_ptr(), m, k, *extra,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, name)
    LAUNCHES[name] += 1
    return y


def lut_matmul_fused_multi(
    x: torch.Tensor,            # (M, K) RAW activations shared by all projections
    inv_stack: torch.Tensor,    # (P, K) f32 — per-projection Eq. 11 multipliers
    cb_stack: torch.Tensor,     # (P, KC) f32 — per-projection padded codebooks
    *packed_list: torch.Tensor, # P × (K*nbits_p//8, n_p) uint8
    quantize: tuple,            # per-projection Eq. 11 quantize flag
    nbits: tuple,               # per-projection packing width
) -> torch.Tensor:
    """Y = concat_p(transform_p(x) @ codebook_p[codes_p]) in ONE launch,
    (M, sum n_p) f32 at the true widths; projection p's columns are the same
    bits as `lut_matmul_fused` on its operands. The caller splits the
    segments and applies each projection's s_q."""
    return _multi("lut_matmul_fused_multi", "lut_multi_gemm_launch", x,
                  inv_stack, cb_stack, packed_list, quantize, nbits)


def lut_matmul_fused_multi_gemv(
    x: torch.Tensor,            # (M, K), M < 128 (decode micro-batch)
    inv_stack: torch.Tensor,    # (P, K) f32
    cb_stack: torch.Tensor,     # (P, KC) f32
    *packed_list: torch.Tensor, # P × (K*nbits_p//8, n_p) uint8
    quantize: tuple,
    nbits: tuple,
) -> torch.Tensor:
    """Decode form of `lut_matmul_fused_multi`: projection p's columns are the
    same bits as `lut_matmul_fused_gemv` on its operands."""
    if x.ndim == 2 and x.shape[0] >= 128:
        raise ValueError(
            f"lut_matmul_fused_multi_gemv: M ({x.shape[0]}) must be < 128")
    return _multi("lut_matmul_fused_multi_gemv", "lut_multi_gemv_launch", x,
                  inv_stack, cb_stack, packed_list, quantize, nbits)
