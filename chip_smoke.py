#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Builds the twelve hand-written CUDA kernels from the sources in this checkout
(the ten that replace the JAX package's Pallas kernels, and the two of the
LUT projection's backward), holds each against its plain PyTorch version on
the card at the shapes
llama2-7b and qwen2-1.5b give it, and the serving ones (B1-B5) at the shapes
of gemma2-27b, starcoder2-15b, stablelm-12b and paligemma-3b (every projection of a multi-projection
launch bit for bit against its solo launch, the §4 layer's int8 LUT GEMM bit
for bit against the fused serving GEMM, the dequantizing attention over a
gathered int8 view bit for bit against the pool-direct one, a query row's
bits from a width-32 launch against a width-1 one), calls the two
attention kernels with their tiles left to the tuner on a fresh cache (every
candidate measured once, nothing on a hit or after a reload), runs the
paper's §4 LUT layer at
llama2-7b's gate_proj width (smoothing, clustering, then the online Eq. 11
transform and the bucket LUT GEMM), checks a 2-layer full-width model on the
card against the same model on the CPU, then serves LCD 4-bit llama2-7b at
full width and full depth (random weights from --seed) through the
continuous-batching engine in the default configuration (fused projections)
and in the per-projection one (the same tokens), and through the
static-batch `serve()` (beside dense bf16 llama2-7b on the same path); the
engine's steps and the static decode run as CUDA graphs, and every replay
of a checking drive is held bit for bit against the eager body on a clone
of the KV pools (`graph` lines); serves speculatively (`serve_spec`: the
2-bit self-draft made on the card, k = 3, a 2-layer full-width llama2-7b)
with the same tokens as the plain engine, the verify's rows bit for bit
those of width-1 steps and the identical draft accepting every round;
serves the rest of the transformer family at full width (`serve_family`:
gemma2-27b, starcoder2-15b and stablelm-12b cut to 4 layers, paligemma-3b at
its 18) and each of the four speculatively, gemma2-27b at 2 layers and the
others at 1 (`serve_spec_family`); serves on (data, model) meshes whose every
coordinate is the one card (`serve_mesh`: one decode step's logits and the
pools at 32 layers on (1, 2) and (2, 1) torch.equal to 1 x 1, the `serve`
drive at 4 layers on both with a 1 x 1 engine's tokens, B1-B5 on a rank's
shard torch.equal to that part of the full launch, the int8 pool on (2, 2),
the layout search's report; and the speculative engine on (1, 2) with plain
greedy's tokens); serves on process meshes (`serve_processes`: (1, 2) and
(2, 1) as two torch.distributed processes on the card over gloo, each
holding only its own shards of `serve`'s weights cut to 4 layers, every
process's tokens, every step's logits and its pool replica equal to the
one-process mesh's, whose tokens equal 1 x 1's, every process launching
B1-B5, a cached system prompt matched across data ranks with the cache-off
tokens, the int8 pool; the bytes a process holds, its collectives and eager
ms per decode step);
compresses a 1-layer full-width llama2-7b
with the LCD pipeline on the card (twice: the same bytes; under a bits
budget; then inside `build_engine`, whose engine serves requests that
decode alike alone); runs the paper's pipeline through the trainer
(`train`: a 4-layer full-width llama2-7b in f32 — forward = decode, 30 train
steps, a checkpoint round trip, compression under the empirical Fisher,
teacher and student CE with the student's forward through the LUT GEMMs at
4096 rows, the codebook fine-tune of the student by self-distillation, its
gradients through the backward kernels, then an engine on the fine-tuned
student); shows, by the kernels' launch counts (a replay adds
what its capture recorded), that each path really went through the
kernels, and reads under torch.profiler where a prefill step's and a
decode step's time goes, graph and eager body in turns; serves the
mixture-of-experts family (`moe_parity`: a 2-layer full-width phi3.5-moe
with its stacked experts clustered, kernels against their plain versions,
the MoE block alone against its f32 run, B1-B5 at both MoE archs' shapes;
`serve_moe`: phi3.5-moe cut to 1 of its 32 layers and llama4-scout to 1 at
full width, every replay equal to its eager body, where a step's time goes,
then phi3.5-moe's layer over an int8 pool and speculatively);
serves the recurrent and hybrid families (`recurrent_parity`: rwkv6-1.6b,
gla-1.3b and zamba2-1.2b at full width and 2 layers, serving steps and the
forward through the kernels against their plain versions, B1 / B3 / B5 at
their shapes; `serve_recurrent`: the three at full width and depth,
through the slot-state engine, every replay equal to its eager body with a
snapshot preemption inside, preempted = unpreempted tokens, the new ops'
row bits at 1 and 8 slots, a decode step's device time by kernel and
profiler range, engine = solo); serves the audio family (`audio_parity`:
whisper-large-v3 at full width, 2 encoder + 2 decoder layers, its encoder,
cross-K/V build, serving steps and forward through the kernels against their
plain versions, B1 / B2 at its shapes, B2 at 1500 rows; `serve_audio`:
whisper at 32 + 32 layers through the slot-state engine, each request's
encoder run once at admission, the same checks as `serve_recurrent`, and
distinct frames giving distinct tokens); serves every family but the dense
one on the (1, 2) and (2, 1) meshes of the card (`serve_mesh_family`: the
MoE archs at 2 layers, their experts cut over the model axis and a step's
rows routed once; rwkv6, gla and zamba2 at 2, whisper at 4 + 4, their
slot state cut by heads; the next decode step's logits, the pools and the
slot state and a drive's tokens torch.equal to 1 x 1, every replay equal to
its eager body, the ops on a rank's part equal to the whole); trains on
(data, model) meshes of the card (`train_mesh`: the `train` cell's
llama2-7b, 3 steps on (2, 1), (1, 2) and (2, 2) against the same steps at
1 x 1, the placed state's bytes, then the elastic restart of a reduced
llama2-7b re-sharded through its checkpoint, then phi3.5-moe at 1 layer,
rwkv6 and gla at 2, zamba2 at 6 and whisper at 2 + 2, full width in f32, 3
steps on (2, 1) and (1, 2) against their own 1 x 1); and runs the dry run
(`dryrun`: every (arch x shape) cell of `--all` on the (16, 16) and
(2, 16, 16) production meshes on "meta" tensors, then its predictions for
the `train` step and the `profile` phase's decode step held to what those
drives measured: argument bytes equal, peak memory and time at least the
prediction). Every phase prints
one JSON line; any failed phase ends the process with a non-zero exit
code. The last line is
`{"ok": true, "device": {...}}`. Without a CUDA card it prints no result and
exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published peaks of one H100 SXM (dense, no sparsity), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}

LLAMA_KN = ((4096, 4096), (4096, 11008), (11008, 4096))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _storage_bytes(*trees) -> int:
    """Bytes of the distinct storages under `trees` (dicts, lists,
    NamedTuples of tensors), each storage counted once."""
    from repro_torch.tree import leaves
    seen = {}
    for tree in trees:
        for x in leaves(tree):
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn(i) over `iters` calls, by CUDA events.

    The calls are captured into a CUDA graph and the graph is replayed, so the
    time is the card's: back-to-back launches with no host in between."""
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    reps = 3
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


# ---------------------------------------------------------------------------
# env / build
# ---------------------------------------------------------------------------

def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    release = next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), "")
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=release, card=smi, python=sys.version.split()[0])
    return smi


def _pool_plan_matches_launchers(lib) -> int:
    """kernels/paged_attention.py pool_plan against the C make_plan the B5 /
    B8 launchers run (paged_attn_plan), for every row count a block can hold
    (1..32, which covers every T and GQA group the script launches), every
    admissible D, each pool type and every stage the wrappers pass (the
    default, and B8's l_pad): the same geometry and shared-memory bytes, and
    a plan refused on the host exceeds the card's limit in C as well.
    Returns the plans compared."""
    import ctypes
    from repro_torch.kernels.paged_attention import _MAX_SMEM, _POOL_KIND, pool_plan
    geom = (ctypes.c_int * 4)()
    n = 0
    for rows in range(1, 33):
        for d in range(32, 257, 32):
            for dtype, kind in _POOL_KIND.items():
                for sk in (None, 32, 64, 96, 128, 256, 512):
                    try:
                        plan = pool_plan(rows, 1, 1, d, dtype, stage_keys=sk)
                    except ValueError:
                        plan = None
                    stage = plan["stage_keys"] if plan is not None else sk or 32
                    smem = lib.paged_attn_plan(rows, stage, d, kind, geom)
                    if plan is None:
                        ok = sk is None or smem > _MAX_SMEM
                    else:
                        ok = (smem == plan["smem_bytes"] and list(geom) == [
                            plan["rows_per_warp"], plan["groups"], plan["warps_per_row"],
                            plan["row_bytes"]])
                    if not ok:
                        raise SystemExit(
                            f"build: pool_plan and the launchers' make_plan disagree at rows "
                            f"{rows}, D {d}, {dtype}, stage {sk}: {plan} vs smem {smem}, "
                            f"geometry {list(geom)}")
                    n += 1
    return n


def _gemv_plan_matches_launchers(lib) -> int:
    """kernels/lut_matmul.py gemv_plan against the C make_plan every GEMV
    launcher (B1, B3, B6 / B7 below 128 rows) runs (lut_gemv_plan): at M 1..127
    and f32, bf16 and int8 activations for the B1 shapes, each of
    MULTI_GROUPS (all 4-bit quantized, then mixed widths and transforms) and
    the ragged (130, 37) case, and a few launches both must refuse. Returns
    the plans compared."""
    import ctypes
    from repro_torch.kernels.lut_matmul import gemv_plan
    out = (ctypes.c_int * 7)()
    groups = [(k, (n,)) for k, n in LLAMA_KN] + list(MULTI_GROUPS.values()) + [(130, (37,))]
    cases = []
    for k, widths in groups:
        p = len(widths)
        for nbits, quantize in (((4,) * p, (True,) * p), ((2,) * p, (False,) * p),
                                ((4, 2, 3)[:p], (True, False, True)[:p]),
                                ((4,) * p, (True, False, True)[:p])):
            cases += [(m, k, widths, nbits, quantize, xb) for m in range(1, 128)
                      for xb in (2, 4, 1)]
    cases += [(128, 4096, (4096,), (4,), (True,), 2), (8, 4096, (0,), (4,), (True,), 2),
              (8, 4096, (64,), (5,), (True,), 2), (8, 4095, (64,), (4,), (True,), 2),
              (8, 4096, (64,) * 9, (4,) * 9, (True,) * 9, 2), (8, 4096, (64,), (4,), (True,), 3)]
    def ints(v):
        return (ctypes.c_int * len(v))(*[int(x) for x in v])

    n = 0
    for m, k, widths, nbits, quantize, xb in cases:
        try:
            plan = gemv_plan(m, k, widths, nbits, quantize, x_bytes=xb, sms=132)
        except ValueError:
            plan = None
        smem = lib.lut_gemv_plan(m, k, len(widths), ints(widths), ints(nbits), ints(quantize),
                                 xb, 132, out)
        ok = smem < 0 if plan is None else (smem == plan["smem_bytes"] and list(out) == [
            plan["rows_per_block"], plan["strips"], plan["row_blocks"], plan["units"],
            plan["stages_per_unit"], plan["grid"], int(plan["uniform"])])
        if not ok:
            raise SystemExit(f"build: gemv_plan and the launchers' make_plan disagree at M {m}, "
                             f"K {k}, widths {widths}, nbits {nbits}, quantize {quantize}, "
                             f"{xb}-byte x: {plan} vs smem {smem}, {list(out)}")
        n += 1
    return n


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.library()
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         compiled=_build.build_seconds is not None,
         sources=[f"src/repro_torch/kernels/csrc/{s}" for s in _build.SOURCES],
         ptxas=_build.resource_usage(),
         pool_plans_equal_to_launchers=_pool_plan_matches_launchers(lib),
         gemv_plans_equal_to_launchers=_gemv_plan_matches_launchers(lib))


# ---------------------------------------------------------------------------
# kernels vs their plain versions, on the card
# ---------------------------------------------------------------------------

def _lut_operands(gen, m, k, n, nbits, dtype, layers):
    """Operands as the model hands them over: layer slices of stacked tensors."""
    from repro_torch.core.lut import packed_rows
    dev = gen.device
    packed = torch.randint(0, 255, (layers, packed_rows(k, nbits), n),
                           generator=gen, dtype=torch.uint8, device=dev)
    cb = torch.sort(torch.randn((layers, 16), generator=gen, device=dev) * 0.02,
                    dim=-1).values
    cb[:, (1 << nbits):] = 0.0
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    smooth = 0.5 + torch.rand((layers, k), generator=gen, device=dev)
    return x, smooth, packed, cb


def _f32_core_ms(m, k, n):
    """2*M*K*N operations at the f32 CUDA-core peak: the least time of a LUT
    kernel, whose canonical K order keeps every fmaf on the CUDA cores."""
    return 2.0 * m * k * n / PEAK_OPS[torch.float32] * 1e3


def _lut_bound_ms(m, k, n, nbits, dtype):
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = m * k * elt + k * 4 + k * n * nbits // 8 + 16 * 4 + m * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * m * k * n / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            _f32_core_ms(m, k, n))


def _lut_check(gen, m, k, n, nbits, dtype, quantize):
    """One B1 (M < 128) or B2 launch against its plain version, and a row's
    bits against the other body's (below 128 rows the GEMM on the same
    rows, from 128 rows on the GEMV on the first and the last 8 rows);
    fails the run on a miss. Returns (case, kernel)."""
    from repro_torch.core.lut import padded_d_in, unpack_codes
    from repro_torch.kernels.lut_matmul import (lut_matmul_fused,
                                                lut_matmul_fused_gemv)
    from repro_torch.kernels.ref import lut_matmul_fused_ref
    kp = padded_d_in(k, nbits)
    x, smooth, packed, cb = _lut_operands(gen, m, kp, n, nbits, dtype, 2)
    s_q = 0.04
    inv = (1.0 / (smooth * s_q)) if quantize else (1.0 / smooth)
    l = 1
    name = "lut_matmul_fused_gemv" if m < 128 else "lut_matmul_fused"
    kern = lut_matmul_fused_gemv if m < 128 else lut_matmul_fused
    y = kern(x, inv[l], packed[l], cb[l], quantize=quantize, nbits=nbits)
    ref = lut_matmul_fused_ref(x, inv[l], packed[l], cb[l], 1.0,
                               quantize=quantize, nbits=nbits)
    torch.cuda.synchronize()
    # |y - ref| <= 1e-5 * max_m ||T(x)_m|| * max_n ||w_n||  (f32 sums
    # of K terms taken in another order)
    xt = x.float() * inv[l]
    if quantize:
        xt = torch.clamp(torch.round(xt), -127, 127)
    w = cb[l][unpack_codes(packed[l], kp, nbits).long()]
    tol = 1e-5 * float(xt.norm(dim=1).max() * w.norm(dim=0).max())
    err = float((y - ref).abs().max())
    ok = bool(torch.isfinite(y).all()) and err <= tol
    same = rows_same = True
    if m < 128:
        y2 = lut_matmul_fused(x, inv[l], packed[l], cb[l], quantize=quantize, nbits=nbits)
        same = bool(torch.equal(y, y2))
    else:
        rows_same = all(bool(torch.equal(y[sl], lut_matmul_fused_gemv(
            x[sl], inv[l], packed[l], cb[l], quantize=quantize, nbits=nbits)))
            for sl in (slice(0, 8), slice(m - 8, m)))
    case = dict(kernel=name, m=m, k=k, n=n, nbits=nbits,
                dtype=str(dtype).split(".")[-1], quantize=quantize,
                max_abs_err=err, tol=tol, gemv_equals_gemm_bits=same,
                first_last_8_rows_equal_gemv_bits=rows_same)
    if not (ok and same and rows_same):
        emit("kernels", failed=case)
        raise SystemExit(f"LUT kernel disagrees with its plain version: {case}")
    return case, kern


def check_lut_kernels(gen):
    cases, worst, headline = [], {"lut_matmul_fused_gemv": 0.0, "lut_matmul_fused": 0.0}, {}
    shapes = [(m, k, n) for (k, n) in LLAMA_KN for m in (4, 8, 32, 256)]
    shapes += [(5, 130, 37), (130, 130, 37)]          # ragged edges, K group padding
    for (m, k, n) in shapes:
        full = k >= 4096
        for nbits in (4, 3, 2):
            for dtype in (torch.bfloat16, torch.float32):
                for quantize in (True, False):
                    main = nbits == 4 and dtype == torch.bfloat16 and quantize
                    # the speculative draft's projections: 2-bit, float transform
                    draft = (nbits == 2 and dtype == torch.bfloat16 and not quantize
                             and m == 8)
                    case, kern = _lut_check(gen, m, k, n, nbits, dtype, quantize)
                    name = case["kernel"]
                    worst[name] = max(worst[name], case["max_abs_err"])
                    if full and (main or draft):
                        case.update(_time_lut(gen, kern, m, k, n, nbits, dtype, quantize))
                        if (k, n) == (4096, 4096) and main and m in (8, 256):
                            headline[name] = case
                    cases.append(case)
    return cases, worst, headline


def _time_lut(gen, kern, m, k, n, nbits, dtype, quantize):
    """Kernel, plain version and the dense bf16 matmul yardstick of the same
    (M, K, N), each walking a stack of layers larger than the 50 MB L2 so that
    every call finds its weights cold, as a serving step does."""
    from repro_torch.kernels.ref import lut_matmul_fused_ref
    per_layer = k * n * nbits // 8
    layers = max(2, math.ceil(128e6 / per_layer))
    x, smooth, packed, cb = _lut_operands(gen, m, k, n, nbits, dtype, layers)
    inv = 1.0 / (smooth * 0.04) if quantize else 1.0 / smooth
    iters = 4 * layers if m < 128 else layers
    call = lambda i: kern(x, inv[i % layers], packed[i % layers], cb[i % layers],  # noqa: E731
                          quantize=quantize, nbits=nbits)
    ms = time_ms(call, iters)
    plain = time_ms(lambda i: lut_matmul_fused_ref(
        x, inv[i % layers], packed[i % layers], cb[i % layers], 1.0,
        quantize=quantize, nbits=nbits), 3, warmup=1)
    dl = max(2, math.ceil(128e6 / (k * n * 2)))
    wd = torch.randn((dl, k, n), generator=gen, device=gen.device,
                     dtype=torch.float32).mul_(0.02).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    dense = time_ms(lambda i: torch.matmul(xb, wd[i % dl]), 4 * dl)
    bound, by, core = _lut_bound_ms(m, k, n, nbits, dtype)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, f32_core_bound_ms=core,
                dense_bf16_matmul_ms=dense)


# the projection groups the main path fuses: (K, output widths)
MULTI_GROUPS = {
    "llama2-7b qkv": (4096, (4096, 4096, 4096)),
    "llama2-7b gate_up": (4096, (11008, 11008)),
    "qwen2-1.5b qkv": (1536, (2048, 256, 256)),       # 12 heads padded to 16, 2 kv heads
    "qwen2-1.5b gate_up": (1536, (8960, 8960)),
}
GEMV_MS, GEMM_MS = (1, 4, 5, 7, 8, 9, 32, 127), (128, 130, 256)


def _multi_operands(gen, m, k, widths, nbits, quantize, dtype, layers):
    """Stacked per-layer operands of a projection group, as the model hands
    them over: inv rows (P, K) and padded codebooks (P, 16) per layer."""
    from repro_torch.core.lut import packed_rows
    dev = gen.device
    packed = [torch.randint(0, 255, (layers, packed_rows(k, nb), n), generator=gen,
                            dtype=torch.uint8, device=dev) for n, nb in zip(widths, nbits)]
    cb = torch.sort(torch.randn((layers, len(widths), 16), generator=gen, device=dev) * 0.02,
                    dim=-1).values
    for p, nb in enumerate(nbits):
        cb[:, p, (1 << nb):] = 0.0
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    smooth = 0.5 + torch.rand((layers, len(widths), k), generator=gen, device=dev)
    qmask = torch.tensor(quantize, device=dev)[None, :, None]
    inv = torch.where(qmask, 1.0 / (smooth * 0.04), 1.0 / smooth).contiguous()
    return x, inv, packed, cb


def _multi_bound_ms(m, k, widths, nbits, dtype):
    elt = torch.empty((), dtype=dtype).element_size()
    p, n = len(widths), sum(widths)
    nbytes = (m * k * elt + p * k * 4 + sum(k * nb * w // 8 for w, nb in zip(widths, nbits))
              + p * 64 + m * n * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * m * k * n / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            _f32_core_ms(m, k, n))


def _multi_check(gen, group, m, k, widths, nbits, quantize, dtype):
    """One B3 (M < 128) or B4 launch against its plain version, every
    projection's segment against its solo B1 / B2 launch on the same
    operands (bits equal, also after the ops wrapper's s_q rescale and the
    cast to x's dtype), and from 128 rows on the first and the last 8 rows
    against the multi GEMV; fails the run on a miss. Returns (case, multi
    kernel, solo kernel)."""
    from repro_torch.core.lut import unpack_codes
    from repro_torch.kernels.lut_matmul import (lut_matmul_fused, lut_matmul_fused_gemv,
                                                lut_matmul_fused_multi,
                                                lut_matmul_fused_multi_gemv)
    from repro_torch.kernels.ops import lut_gemm_fused, lut_gemm_fused_multi
    from repro_torch.kernels.ref import lut_matmul_fused_multi_ref
    gemv = m < 128
    name = "lut_matmul_fused_multi_gemv" if gemv else "lut_matmul_fused_multi"
    multi = lut_matmul_fused_multi_gemv if gemv else lut_matmul_fused_multi
    solo = lut_matmul_fused_gemv if gemv else lut_matmul_fused
    x, inv, packed, cb = _multi_operands(gen, m, k, widths, nbits, quantize, dtype, 1)
    pk = [t[0] for t in packed]
    y = multi(x, inv[0], cb[0], *pk, quantize=quantize, nbits=nbits)
    segs = y.split(list(widths), dim=1)
    ref = lut_matmul_fused_multi_ref(x, list(inv[0]), pk, list(cb[0]), [1.0] * len(widths),
                                     quantize=quantize, nbits=nbits)
    acts = [0.04 if q else 1.0 for q in quantize]
    wrapped = lut_gemm_fused_multi(x, inv[0], cb[0], acts, *pk, quantize=quantize,
                                   nbits=nbits)
    same, errs, tols = True, [], []
    rows_same = gemv or all(bool(torch.equal(y[sl], lut_matmul_fused_multi_gemv(
        x[sl], inv[0], cb[0], *pk, quantize=quantize, nbits=nbits)))
        for sl in (slice(0, 8), slice(m - 8, m)))
    for i, (seg, r) in enumerate(zip(segs, ref)):
        same &= bool(torch.equal(seg, solo(x, inv[0, i], pk[i], cb[0, i],
                                           quantize=quantize[i], nbits=nbits[i])))
        alone = lut_gemm_fused(x, inv[0, i], pk[i], cb[0, i], acts[i],
                               quantize=quantize[i], nbits=nbits[i])
        same &= bool(torch.equal(wrapped[i].to(dtype), alone.to(dtype)))
        # |y - ref| <= 1e-5 * max_m ||T(x)_m|| * max_n ||w_n||, per projection
        # (f32 sums of K terms taken in another order)
        xt = x.float() * inv[0, i]
        if quantize[i]:
            xt = torch.clamp(torch.round(xt), -127, 127)
        w = cb[0, i][unpack_codes(pk[i], k, nbits[i]).long()]
        tols.append(1e-5 * float(xt.norm(dim=1).max() * w.norm(dim=0).max()))
        errs.append(float((seg - r).abs().max()))
    torch.cuda.synchronize()
    case = dict(kernel=name, group=group, m=m, k=k, widths=list(widths), nbits=list(nbits),
                quantize=list(quantize), dtype=str(dtype).split(".")[-1],
                max_abs_err=max(errs), tol=min(tols), segments_equal_solo_bits=same,
                first_last_8_rows_equal_gemv_bits=rows_same)
    if not (same and rows_same and bool(torch.isfinite(y).all())
            and all(e <= t for e, t in zip(errs, tols))):
        emit("kernels", failed=case)
        raise SystemExit(f"multi-projection kernel disagrees: {case}")
    return case, multi, solo


def check_multi_kernels(gen):
    """B3 / B4 at the projection groups of MULTI_GROUPS (`_multi_check`), and
    a ragged K beside mixed widths through the ops wrapper."""
    from repro_torch.kernels.ops import lut_gemm_fused, lut_gemm_fused_multi

    names = ("lut_matmul_fused_multi_gemv", "lut_matmul_fused_multi")
    cases, worst, headline = [], {n: 0.0 for n in names}, {}
    plan = []
    for group, (k, widths) in MULTI_GROUPS.items():
        p = len(widths)
        main = ((4,) * p, (True,) * p, torch.bfloat16)
        for m in GEMV_MS + GEMM_MS:
            plan.append((group, m, *main))
        # the speculative draft's groups: 2-bit, float transform, M = 8
        plan.append((group, 8, (2,) * p, (False,) * p, torch.bfloat16))
        for m in (5, 130):
            plan += [(group, m, (4,) * p, (True,) * p, torch.float32),
                     (group, m, (4, 2, 2)[:p], (True,) * p, torch.bfloat16),
                     (group, m, (3, 3, 3)[:p], (True,) * p, torch.bfloat16),
                     (group, m, (4,) * p, (True, False, True)[:p], torch.float32)]
    for group, m, nbits, quantize, dtype in plan:
        k, widths = MULTI_GROUPS[group]
        case, multi, solo = _multi_check(gen, group, m, k, widths, nbits, quantize, dtype)
        name = case["kernel"]
        worst[name] = max(worst[name], case["max_abs_err"])
        llama = group.startswith("llama2-7b")
        timed = m in (8, 256) or (m in (4, 32) and llama)
        main = dtype == torch.bfloat16 and nbits == (4,) * len(widths) and all(quantize)
        draft = llama and m == 8 and nbits == (2,) * len(widths) and not any(quantize)
        if (timed and main) or draft:
            case.update(_time_multi(gen, multi, solo, m, k, widths, nbits, quantize, dtype))
            if group == "llama2-7b qkv" and main and m in (8, 256):
                headline[name] = case
        cases.append(case)
    # ragged K beside mixed widths: the ops wrapper pads K to the widest
    # packing group and a narrower projection's codes with zero rows
    for m in (5, 130):
        k, widths, nbits, quantize = 130, (37, 16, 8), (4, 2, 3), (True, False, True)
        x, inv, packed, cb = _multi_operands(gen, m, k, widths, nbits, quantize,
                                             torch.bfloat16, 1)
        acts = [0.04 if q else 1.0 for q in quantize]
        wrapped = lut_gemm_fused_multi(x, inv[0], cb[0], acts, *[t[0] for t in packed],
                                       quantize=quantize, nbits=nbits)
        same = all(bool(torch.equal(wrapped[i], lut_gemm_fused(
            x, inv[0, i], packed[i][0], cb[0, i], acts[i], quantize=quantize[i],
            nbits=nbits[i]))) for i in range(3))
        case = dict(kernel=names[m >= 128], group="ragged K", m=m, k=k, widths=list(widths),
                    nbits=list(nbits), quantize=list(quantize),
                    segments_equal_solo_bits=same)
        if not same:
            emit("kernels", failed=case)
            raise SystemExit(f"multi-projection kernel disagrees: {case}")
        cases.append(case)
    return cases, worst, headline


def _packed_at(gen, rows, n, offset):
    """Random packed codes (rows, n) whose data pointer is `offset` bytes past
    a 16-byte boundary (a contiguous view into a larger buffer)."""
    buf = torch.randint(0, 255, (rows * n + 16,), generator=gen, dtype=torch.uint8,
                        device=gen.device)
    pk = buf[offset:offset + rows * n].view(rows, n)
    assert pk.data_ptr() % 16 == offset % 16
    return pk


def check_gemv_edges(gen):
    """The GEMV body's other paths against the plain version, with the bits
    checked as everywhere: packed codes 4 but not 16 bytes aligned, N = 4100
    (a multiple of 4, not of 16), both taking ordinary loads, and M 1, 7, 9,
    127 (MT = 4 and 8, a partial and several row blocks). B1 rows equal the
    GEMM's bits on the same rows; every B3 segment equals its solo launch."""
    from repro_torch.core.lut import unpack_codes
    from repro_torch.kernels.lut_matmul import (lut_matmul_fused, lut_matmul_fused_gemv,
                                                lut_matmul_fused_multi_gemv)
    from repro_torch.kernels.ref import lut_matmul_fused_ref
    dev = gen.device
    k = 4096
    cases, worst = [], 0.0
    solo_cases = [(m, 4096, 0) for m in (1, 7, 9, 127)] + [(8, 4100, 0), (8, 4096, 4),
                                                          (5, 4100, 4)]
    for m, n, offset in solo_cases:
        for dtype in (torch.bfloat16, torch.float32):
            pk = _packed_at(gen, k // 2, n, offset)
            cb = torch.sort(torch.randn(16, generator=gen, device=dev) * 0.02).values
            inv = 1.0 / ((0.5 + torch.rand(k, generator=gen, device=dev)) * 0.04)
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            y = lut_matmul_fused_gemv(x, inv, pk, cb, quantize=True, nbits=4)
            ref = lut_matmul_fused_ref(x, inv, pk, cb, 1.0, quantize=True, nbits=4)
            same = bool(torch.equal(y, lut_matmul_fused(x, inv, pk, cb, quantize=True, nbits=4)))
            xt = torch.clamp(torch.round(x.float() * inv), -127, 127)
            w = cb[unpack_codes(pk, k, 4).long()]
            tol = 1e-5 * float(xt.norm(dim=1).max() * w.norm(dim=0).max())
            err = float((y - ref).abs().max())
            case = dict(kernel="lut_matmul_fused_gemv", edge=True, m=m, k=k, n=n,
                        codes_offset=offset, dtype=str(dtype).split(".")[-1], max_abs_err=err,
                        tol=tol, gemv_equals_gemm_bits=same)
            if not (same and err <= tol and bool(torch.isfinite(y).all())):
                emit("kernels", failed=case)
                raise SystemExit(f"GEMV edge case disagrees: {case}")
            worst = max(worst, err)
            cases.append(case)
    # B3: a 4100-wide projection beside a misaligned one, uniform and mixed
    for m in (1, 7, 9, 127):
        for nbits, quantize in (((4, 4, 4), (True,) * 3), ((4, 2, 4), (True, False, True))):
            widths, offsets = (4100, 4096, 64), (0, 4, 0)
            pks = [_packed_at(gen, k * b // 8, w, o) for w, b, o in zip(widths, nbits, offsets)]
            cb = torch.sort(torch.randn((3, 16), generator=gen, device=dev) * 0.02,
                            dim=-1).values
            for p, b in enumerate(nbits):
                cb[p, (1 << b):] = 0.0
            inv = 1.0 / ((0.5 + torch.rand((3, k), generator=gen, device=dev)) * 0.04)
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            y = lut_matmul_fused_multi_gemv(x, inv, cb, *pks, quantize=quantize, nbits=nbits)
            same = all(bool(torch.equal(seg, lut_matmul_fused_gemv(
                x, inv[p], pks[p], cb[p], quantize=quantize[p], nbits=nbits[p])))
                for p, seg in enumerate(y.split(list(widths), dim=1)))
            case = dict(kernel="lut_matmul_fused_multi_gemv", edge=True, m=m, k=k,
                        widths=list(widths), codes_offsets=list(offsets), nbits=list(nbits),
                        quantize=list(quantize), segments_equal_solo_bits=same)
            if not (same and bool(torch.isfinite(y).all())):
                emit("kernels", failed=case)
                raise SystemExit(f"GEMV edge case disagrees: {case}")
            cases.append(case)
    torch.cuda.synchronize()
    return cases, worst


def _time_multi(gen, multi, solo, m, k, widths, nbits, quantize, dtype):
    """The multi kernel, its P solo launches and its plain version on the same
    shapes, each walking a stack of layers larger than the 50 MB L2."""
    from repro_torch.kernels.ref import lut_matmul_fused_multi_ref
    per_layer = sum(k * w * nb // 8 for w, nb in zip(widths, nbits))
    layers = max(2, math.ceil(128e6 / per_layer))
    x, inv, packed, cb = _multi_operands(gen, m, k, widths, nbits, quantize, dtype, layers)
    iters = 4 * layers if m < 128 else layers

    def fused(i):
        l = i % layers
        multi(x, inv[l], cb[l], *[t[l] for t in packed], quantize=quantize, nbits=nbits)

    def solos(i):
        l = i % layers
        for p in range(len(widths)):
            solo(x, inv[l, p], packed[p][l], cb[l, p], quantize=quantize[p], nbits=nbits[p])

    def plain(i):
        l = i % layers
        lut_matmul_fused_multi_ref(x, list(inv[l]), [t[l] for t in packed], list(cb[l]),
                                   [1.0] * len(widths), quantize=quantize, nbits=nbits)

    ms = time_ms(fused, iters)
    solo_ms = time_ms(solos, iters)
    bound, by, core = _multi_bound_ms(m, k, widths, nbits, dtype)
    return dict(ms=ms, solo_sum_ms=solo_ms, plain_ms=time_ms(plain, 3, warmup=1),
                bound_ms=bound, bound_by=by, f32_core_bound_ms=core)


def _attn_case(gen, t, h, kv, qdtype, pool, window, softcap, lengths=None, n_new=None,
               d=128, nbw=32):
    """B5's operands at the `serve` engine's geometry (8 slots, 16-token
    blocks, `nbw` table entries a slot, at least 256 blocks), and the bound
    of the work this data needs."""
    from repro_torch.models.layers import quantize_kv
    dev = gen.device
    s, bs = 8, 16
    nb = max(256, s * nbw)
    # ragged: a long slot, short ones, one idle slot, one chunk with n_new < T
    if lengths is None:
        lengths = torch.tensor([200, 37, 0, 95, 16, 0, 130, 63], dtype=torch.int32)
        n_new = torch.tensor([t, t, 0, max(t // 2, 1), t, t, 1, t], dtype=torch.int32)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(1))[:s * nbw]
    tables = perm.reshape(s, nbw).to(torch.int32)
    kf = torch.randn((nb, bs, kv, d), generator=gen, device=dev)
    vf = torch.randn((nb, bs, kv, d), generator=gen, device=dev)
    q = torch.randn((s, t, h, d), generator=gen, device=dev).to(qdtype)
    kw = {}
    if pool == "int8":
        ksm = 0.5 + torch.rand((kv, d), generator=gen, device=dev)
        vsm = 0.5 + torch.rand((kv, d), generator=gen, device=dev)
        kp, ks = quantize_kv(kf, ksm)
        vp, vs = quantize_kv(vf, vsm)
        kw = dict(k_scale=ks.contiguous(), v_scale=vs.contiguous(), k_smooth=ksm, v_smooth=vsm)
    else:
        pdt = torch.float32 if pool == "f32" else torch.bfloat16
        kp, vp = kf.to(pdt), vf.to(pdt)
    args = (q, kp.contiguous(), vp.contiguous(), tables.to(dev), lengths.to(dev),
            n_new.to(dev), window)
    kw["softcap"] = softcap
    # what this data needs: for a slot with new tokens, the K and V rows its
    # queries can see (length + n_new, narrowed by the window), its table
    # entries, and the q / out rows of its new tokens; nothing for a slot
    # without new tokens
    g = h // kv
    seen = rows = entries = pairs = 0
    for a, b in zip(lengths.tolist(), n_new.tolist()):
        if b == 0:
            continue
        lo = max(0, a - window + 1) if window > 0 else 0
        seen += a + b - lo
        entries += math.ceil((a + b) / bs) - lo // bs
        rows += b
        for tt in range(b):
            qp = a + tt
            pairs += qp - (max(0, qp - window + 1) if window > 0 else 0) + 1
    nbytes = 2 * seen * kv * d * kp.element_size() + 2 * rows * h * d * q.element_size()
    nbytes += entries * 4 + 2 * s * 4
    if pool == "int8":
        nbytes += 2 * seen * kv * 4 + 2 * kv * d * 4
    ops = 4.0 * pairs * g * kv * d
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[qdtype]
    # the kernel computes in f32 on the CUDA cores: the same operations at
    # that rate are the least time its arithmetic can take
    bound = dict(bound_ms=max(t_b, t_o) * 1e3, bound_by="bytes" if t_b >= t_o else "operations",
                 f32_core_bound_ms=ops / PEAK_OPS[torch.float32] * 1e3)
    return args, kw, bound


def _attn_row_bits_do_not_depend_on_t(gen):
    """A row's bits do not depend on T (csrc/paged_attention.cuh, the
    canonical per-row key order): a width-T launch in which some slots decode
    (n_new = 1) beside prefill chunks, and the T = 1 launch over the same
    pools, tables and first query rows; row 0 of every slot with new tokens
    must be torch.equal. This is what engine = solo tokens rests on. T runs
    over every block shape of pool_plan: at H = KV (g = 1) T = 32 gives 4
    rows a warp, 16 (the engine's prefill chunk) 2, 8 one row a warp, 4 and 2
    the warps splitting the chunks of 4 and 2 rows; with qwen2-1.5b's group
    of 6 the T = 1 launch has 6 rows and every wider one 2 or 4 a warp."""
    from repro_torch.kernels.paged_attention import paged_pool_attention
    lengths = torch.tensor([200, 37, 0, 95, 16, 480, 130, 63], dtype=torch.int32)
    held = []
    for t in (32, 16, 8, 4, 2):
        n_new = torch.tensor([1, t, 0, 1, t, 1, 1, t // 2 + 1], dtype=torch.int32)
        for (h, kv) in ((32, 32), (12, 2)):
            for qdtype, pool in ((torch.bfloat16, "bf16"), (torch.float32, "f32"),
                                 (torch.bfloat16, "int8")):
                for window, softcap in ((0, 0.0), (64, 0.0), (0, 30.0)):
                    held.append(_row_bits_case(gen, t, h, kv, qdtype, pool, window, softcap,
                                               lengths, n_new))
    return held


# the speculative verify at k = 3: the `serve` engine's ragged lengths, every
# slot with tokens feeding k + 1 = 4, two idle slots
VERIFY_LENGTHS = torch.tensor([200, 37, 0, 95, 16, 0, 130, 63], dtype=torch.int32)
VERIFY_N_NEW = torch.tensor([4, 4, 0, 4, 4, 0, 4, 4], dtype=torch.int32)


def _attn_verify_rows_match_t1(gen):
    """Row j of a T = 4 launch (the verify) against the T = 1 launch of the
    same pools whose slots hold j more tokens: a query at position L + j sees
    the same keys either way, and under the per-row key order must get the
    same bits (torch.equal) — what the verify's rows being a width-1 step's
    rests on, at B5's level."""
    from repro_torch.kernels.paged_attention import paged_pool_attention
    held = 0
    for (h, kv) in ((32, 32), (12, 2)):
        for qdtype, pool in ((torch.bfloat16, "bf16"), (torch.float32, "f32"),
                             (torch.bfloat16, "int8")):
            for window, softcap in ((0, 0.0), (64, 0.0), (0, 30.0)):
                args, kw, _ = _attn_case(gen, 4, h, kv, qdtype, pool, window, softcap,
                                         lengths=VERIFY_LENGTHS, n_new=VERIFY_N_NEW)
                q, kp, vp, tables, lens, nn, win = args
                wide = paged_pool_attention(*args, **kw)
                one_new = torch.clamp(nn, max=1)
                for j in range(4):
                    one = paged_pool_attention(q[:, j:j + 1].contiguous(), kp, vp, tables,
                                               lens + j * one_new, one_new, win, **kw)
                    live = [i for i, n in enumerate(VERIFY_N_NEW.tolist()) if n]
                    same = all(torch.equal(wide[i, j], one[i, 0]) for i in live)
                    if not same:
                        case = dict(h=h, kv=kv, pool=pool, q=str(qdtype).split(".")[-1],
                                    window=window, softcap=softcap, row=j)
                        emit("kernels", failed=case)
                        raise SystemExit(f"paged_pool_attention: a verify row's bits differ "
                                         f"from a T = 1 launch's: {case}")
                    held += len(live)
    return held


def _row_bits_case(gen, t, h, kv, qdtype, pool, window, softcap, lengths, n_new, d=128,
                   nbw=32):
    from repro_torch.kernels.paged_attention import paged_pool_attention
    args, kw, _ = _attn_case(gen, t, h, kv, qdtype, pool, window, softcap,
                             lengths=lengths, n_new=n_new, d=d, nbw=nbw)
    q, kp, vp, tables, lens, nn, win = args
    wide = paged_pool_attention(*args, **kw)
    one = paged_pool_attention(q[:, :1].contiguous(), kp, vp, tables, lens,
                               torch.clamp(nn, max=1), win, **kw)
    torch.cuda.synchronize()
    live = [i for i, n in enumerate(n_new.tolist()) if n > 0]
    decoding = [i for i, n in enumerate(n_new.tolist()) if n == 1]
    case = dict(t=t, h=h, kv=kv, d=d, pool=pool, q=str(qdtype).split(".")[-1],
                window=window, softcap=softcap, decoding_slots=decoding,
                row0_equal=all(torch.equal(wide[i, 0], one[i, 0]) for i in live))
    if not case["row0_equal"]:
        emit("kernels", failed=case)
        raise SystemExit(f"paged_pool_attention: a row's bits depend on T: {case}")
    return case


def _attn_vs_plain(gen, t, h, kv, qdtype, pool, window, softcap, d=128, lengths=None,
                   n_new=None, nbw=32):
    """One B5 case against its plain version; fails the run on a miss."""
    from repro_torch.kernels.paged_attention import paged_pool_attention
    from repro_torch.kernels.ref import paged_pool_attention_ref
    args, kw, bound = _attn_case(gen, t, h, kv, qdtype, pool, window, softcap,
                                 lengths=lengths, n_new=n_new, d=d, nbw=nbw)
    out = paged_pool_attention(*args, **kw)
    ref = paged_pool_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    # f32 rows: online vs materialized softmax, f32 rounding only.
    # bf16 rows: both round an f32 result to bf16 — one bf16 ulp.
    scale = float(ref.float().abs().max())
    tol = 5e-5 * max(scale, 1.0) if qdtype == torch.float32 else 2.0 ** -7 * max(scale, 1.0)
    err = float((out.float() - ref.float()).abs().max())
    idle_zero = bool((out[2] == 0).all())     # slot 2: nothing visible
    case = dict(kernel="paged_pool_attention", t=t, h=h, kv=kv, d=d, pool=pool,
                q=str(qdtype).split(".")[-1], window=window, softcap=softcap,
                max_abs_err=err, tol=tol, idle_slot_zero=idle_zero)
    if not (bool(torch.isfinite(out.float()).all()) and err <= tol and idle_zero):
        emit("kernels", failed=case)
        raise SystemExit(f"attention kernel disagrees with its plain version: {case}")
    return case, args, kw, bound


def check_attention_kernel(gen):
    from repro_torch.kernels.paged_attention import paged_pool_attention
    from repro_torch.kernels.ref import paged_pool_attention_ref
    cases, worst, headline = [], 0.0, None
    for t in (1, 32):
        for (h, kv) in ((32, 32), (16, 2)):
            for qdtype, pool in ((torch.bfloat16, "bf16"), (torch.float32, "f32"),
                                 (torch.bfloat16, "int8"), (torch.float32, "int8"),
                                 (torch.float32, "bf16")):
                for window, softcap in ((0, 0.0), (64, 0.0), (0, 30.0)):
                    case, args, kw, bound = _attn_vs_plain(gen, t, h, kv, qdtype, pool,
                                                           window, softcap)
                    worst = max(worst, case["max_abs_err"])
                    if (h, kv) == (32, 32) and pool == "bf16" and window == 0 \
                            and softcap == 0.0 and qdtype == torch.bfloat16:
                        _time_attn(case, args, kw, bound)
                        if t == 1:
                            headline = case
                    cases.append(case)
    # the instances for a D other than 128 (D / 32 read at run time): the
    # reduced configurations' D = 32, and 64 and 256, at every rows-a-warp
    # plan (T = 1 with its split warps, 16, 32), under the same tolerances
    for d in (32, 64, 256):
        for t, (h, kv) in ((1, (32, 32)), (16, (32, 32)), (32, (16, 2))):
            for qdtype, pool in ((torch.bfloat16, "bf16"), (torch.float32, "f32"),
                                 (torch.bfloat16, "int8")):
                for window, softcap in ((0, 0.0), (64, 30.0)):
                    case = _attn_vs_plain(gen, t, h, kv, qdtype, pool, window, softcap,
                                          d=d)[0]
                    worst = max(worst, case["max_abs_err"])
                    cases.append(case)
    # two more timed shapes: qwen2-1.5b's GQA (12 heads over 2) at T = 32, and
    # every slot at 480 cached tokens (the engine's full 32-block table) at T = 1
    for label, t, h, kv, lens, nn in (
            ("verify T=4", 4, 32, 32, VERIFY_LENGTHS, VERIFY_N_NEW),
            ("qwen2-1.5b gqa", 32, 12, 2, None, None),
            ("full table", 1, 32, 32, torch.full((8,), 480, dtype=torch.int32),
             torch.ones(8, dtype=torch.int32))):
        args, kw, bound = _attn_case(gen, t, h, kv, torch.bfloat16, "bf16", 0, 0.0,
                                     lengths=lens, n_new=nn)
        out = paged_pool_attention(*args, **kw)
        ref = paged_pool_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        tol = 2.0 ** -7 * max(float(ref.float().abs().max()), 1.0)
        err = float((out.float() - ref.float()).abs().max())
        case = dict(kernel="paged_pool_attention", case=label, t=t, h=h, kv=kv, pool="bf16",
                    q="bfloat16", window=0, softcap=0.0, max_abs_err=err, tol=tol)
        if not (bool(torch.isfinite(out.float()).all()) and err <= tol):
            emit("kernels", failed=case)
            raise SystemExit(f"attention kernel disagrees with its plain version: {case}")
        worst = max(worst, err)
        _time_attn(case, args, kw, bound)
        cases.append(case)
    return cases, worst, headline


def _time_attn(case, args, kw, bound):
    from repro_torch.kernels.paged_attention import paged_pool_attention, pool_plan
    from repro_torch.kernels.ref import paged_pool_attention_ref
    q, kp = args[0], args[1]
    case["plan"] = pool_plan(q.shape[1], q.shape[2], kp.shape[2], q.shape[3], kp.dtype,
                             s_slots=q.shape[0])
    case["ms"] = time_ms(lambda i: paged_pool_attention(*args, **kw), 50)
    case["plain_ms"] = time_ms(lambda i: paged_pool_attention_ref(*args, **kw), 5, warmup=1)
    case.update(bound)


# the rest of the transformer family: each arch's projections at M = 8 (B1,
# B3), gemma2-27b's, the widest, at M = 256 (B2, B4), and each arch's
# attention (B5) at T = 1 and 32
FAMILY = ("gemma2-27b", "starcoder2-15b", "stablelm-12b", "paligemma-3b")
# slots past gemma2-27b's 4096-token window, one just inside it, short and idle ones
WINDOW_LENGTHS = torch.tensor([4400, 37, 0, 4090, 16, 0, 130, 4500], dtype=torch.int32)


def _family_shapes(arch):
    """(solo launches {projection: (K, N)}, multi launches {group: (K,
    widths)}) of an arch's layer: QKV is one multi launch, and gate+up where
    the MLP has a gate; wo, w_down and the gelu MLP's w_up are solo. An MoE
    layer's LUT launches are its attention's (QKV and wo). rwkv6's and gla's
    projections are all solo (each distinct (K, N) once); zamba2's mamba
    layer has w_in and w_out, its shared block the transformer's launches."""
    from repro_torch.models.config import get_config
    cfg = get_config(arch)
    d, q, kv, f = cfg.d_model, cfg.q_dim_eff, cfg.kv_dim, cfg.d_ff
    if cfg.family in ("rwkv", "linear_attn"):
        return {"d x d (r k v g o; q k v o)": (d, d), "up": (d, f), "down": (f, d)}, {}
    solo, groups = {"wo": (q, d), "w_down": (f, d)}, {"qkv": (d, (q, kv, kv))}
    if cfg.family == "hybrid":
        from repro_torch.models.zamba2 import _mamba_in_dim
        solo.update(w_in=(d, _mamba_in_dim(cfg)), w_out=(cfg.d_inner, d))
    if cfg.n_experts:
        del solo["w_down"]
    elif cfg.mlp == "swiglu":
        groups["gate_up"] = (d, (f, f))
    else:
        solo["w_up"] = (d, f)
    return solo, groups


def check_family_kernels(gen, archs=None, rows=None):
    """B1-B5 at the shapes and options the rest of the family gives them,
    4-bit codes, bf16 activations, quantized transform, bf16 pool: each case
    against its plain version (the tolerances of `_lut_check`,
    `_multi_check`, `_attn_vs_plain`, stated per case), timed by CUDA-graph
    replay with the weights cold. B5 at each arch's heads and D (stablelm
    D 160, paligemma 16 query heads over one kv head at D 256, starcoder2 48
    over 4, gemma2 32 over 16 with its softcap of 50 and window of 4096 over
    slots holding up to 4500 tokens, where the same launch without the window
    must differ on every slot past it), and a row's bits at T = 32 against
    T = 1 for each. `archs` (FAMILY by default) and `rows` (the LUT
    kernels' M; 8, and 256 too for gemma2-27b, by default) choose the
    cases. Returns (cases, worst error per kernel)."""
    from repro_torch.kernels.paged_attention import paged_pool_attention
    from repro_torch.models.config import get_config
    bf16, cases, worst = torch.bfloat16, [], {}

    def keep(case):
        worst[case["kernel"]] = max(worst.get(case["kernel"], 0.0), case["max_abs_err"])
        cases.append(case)

    for arch in archs or FAMILY:
        solo, groups = _family_shapes(arch)
        for m in rows or ((8, 256) if arch == "gemma2-27b" else (8,)):
            for proj, (k, n) in solo.items():
                case, kern = _lut_check(gen, m, k, n, 4, bf16, True)
                case.update(arch=arch, group=proj,
                            **_time_lut(gen, kern, m, k, n, 4, bf16, True))
                keep(case)
            for group, (k, widths) in groups.items():
                bits, quant = (4,) * len(widths), (True,) * len(widths)
                case, multi, one = _multi_check(gen, f"{arch} {group}", m, k, widths, bits,
                                                quant, bf16)
                case.update(arch=arch, **_time_multi(gen, multi, one, m, k, widths, bits,
                                                     quant, bf16))
                keep(case)
        cfg = get_config(arch)
        if cfg.family in ("rwkv", "linear_attn"):
            continue                           # no attention
        h, kv, d = cfg.n_heads_eff, cfg.n_kv_heads, cfg.hd
        window, softcap = cfg.local_window, cfg.attn_softcap
        lengths, nbw = (WINDOW_LENGTHS, 320) if window else (None, 32)
        # zamba2's step feeds its shared block one token at a time: T = 1 only
        for t in (1,) if cfg.family == "hybrid" else (1, 32):
            n_new = None if lengths is None else torch.tensor(
                [t, t, 0, max(t // 2, 1), t, t, 1, t], dtype=torch.int32)
            case, args, kw, bound = _attn_vs_plain(gen, t, h, kv, bf16, "bf16", window,
                                                   softcap, d=d, lengths=lengths,
                                                   n_new=n_new, nbw=nbw)
            case["arch"] = arch
            if window:
                out = paged_pool_attention(*args, **kw)
                unwindowed = paged_pool_attention(*args[:-1], 0, **kw)
                past = [i for i, (a, b) in enumerate(zip(lengths.tolist(), n_new.tolist()))
                        if b and a + b > window]
                case["window_cuts_slots"] = past
                if not past or any(torch.equal(out[i], unwindowed[i]) for i in past):
                    emit("kernels", failed=case)
                    raise SystemExit(f"paged_pool_attention: the window cut nothing: {case}")
            _time_attn(case, args, kw, bound)
            keep(case)
        if cfg.family == "hybrid":
            continue
        rows_lengths = (WINDOW_LENGTHS if window else
                        torch.tensor([200, 37, 0, 95, 16, 480, 130, 63], dtype=torch.int32))
        rows_n_new = torch.tensor([1, 32, 0, 1, 32, 1, 1, 17], dtype=torch.int32)
        case = _row_bits_case(gen, 32, h, kv, bf16, "bf16", window, softcap, rows_lengths,
                              rows_n_new, d=d, nbw=nbw)
        cases.append(dict(kernel="paged_pool_attention", arch=arch, **case))
    return cases, worst


# the §4 layer's kernels: B6 (float activations), B7 (int8 codes), B10

PLAIN_MS = (1, 8, 127, 128, 256)


def _plain_bound_ms(m, k, n, nbits, xdtype):
    """Each input read once, the output written once; 2*M*K*N operations at
    the peak rate of the activation's type (int8 codes: the int8 rate)."""
    elt = torch.empty((), dtype=xdtype).element_size()
    nbytes = m * k * elt + k * n * nbits // 8 + 16 * 4 + 4 + m * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * m * k * n / PEAK_OPS[xdtype]
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            _f32_core_ms(m, k, n))


def _time_plain(gen, name, m, k, n, nbits):
    """B6 (f32 x) or B7 and their plain versions at one shape, each walking a
    stack of layers larger than the 50 MB L2 (cold weights)."""
    from repro_torch.core.lut import packed_rows
    from repro_torch.kernels.lut_matmul import lut_matmul_f32, lut_matmul_int8
    from repro_torch.kernels.ref import lut_matmul_f32_ref, lut_matmul_int8_ref
    dev = gen.device
    layers = max(2, math.ceil(128e6 / (k * n * nbits // 8)))
    packed = torch.randint(0, 255, (layers, packed_rows(k, nbits), n), generator=gen,
                           dtype=torch.uint8, device=dev)
    cb = torch.sort(torch.randn((layers, 16), generator=gen, device=dev) * 0.02, dim=-1).values
    act = torch.tensor(0.03, device=dev)
    if name == "lut_matmul_int8":
        x = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8, device=dev)
        kern = lambda i: lut_matmul_int8(x, packed[i % layers], cb[i % layers], act,  # noqa: E731
                                         nbits=nbits)
        plain = lambda i: lut_matmul_int8_ref(x, packed[i % layers], cb[i % layers],  # noqa: E731
                                              act, nbits=nbits)
    else:
        x = torch.randn((m, k), generator=gen, device=dev)
        kern = lambda i: lut_matmul_f32(x, packed[i % layers], cb[i % layers],  # noqa: E731
                                        nbits=nbits)
        plain = lambda i: lut_matmul_f32_ref(x, packed[i % layers], cb[i % layers],  # noqa: E731
                                             nbits=nbits)
    iters = 4 * layers if m < 128 else layers
    bound, by, core = _plain_bound_ms(m, k, n, nbits, x.dtype)
    return dict(ms=time_ms(kern, iters), plain_ms=time_ms(plain, 3, warmup=1),
                bound_ms=bound, bound_by=by, f32_core_bound_ms=core)


def check_plain_kernels(gen):
    """B6 and B7 against their plain versions (nbits 2/3/4, M in PLAIN_MS,
    llama2-7b and ragged K and N, f32 and bf16 x for B6), B7 bit for bit
    against B2/B1 through the ops wrappers wherever q = clip(round(x*inv),
    ±127), and B10 exactly equal to its plain version at bits 8 and 4 with
    inputs that saturate at -2^(bits-1)."""
    from repro_torch.core.lut import packed_rows, padded_d_in, unpack_codes
    from repro_torch.kernels.lut_matmul import lut_matmul_f32, lut_matmul_int8
    from repro_torch.kernels.ops import lut_gemm_fused, lut_gemm_int8
    from repro_torch.kernels.ref import (lut_matmul_f32_ref, lut_matmul_int8_ref,
                                         smooth_quant_ref)
    from repro_torch.kernels.smooth_quant import smooth_quant

    dev = gen.device
    names = ("lut_matmul_f32", "lut_matmul_int8", "smooth_quant")
    cases, worst, headline = [], {n: 0.0 for n in names}, {}
    fail = []
    shapes = [(k, n) for k, n in LLAMA_KN] + [(130, 37)]
    for (k, n) in shapes:
        for nbits in (4, 3, 2):
            kp = padded_d_in(k, nbits)          # ragged K: the group-padded width
            packed = torch.randint(0, 255, (packed_rows(kp, nbits), n), generator=gen,
                                   dtype=torch.uint8, device=dev)
            cb = torch.sort(torch.randn(16, generator=gen, device=dev) * 0.02).values
            cb[(1 << nbits):] = 0.0
            w = cb[unpack_codes(packed, kp, nbits).long()]
            wmax = float(w.norm(dim=0).max())
            for m in PLAIN_MS:
                runs = []
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, kp), generator=gen, device=dev).to(dtype)
                    runs.append(("lut_matmul_f32", str(dtype).split(".")[-1],
                                 lut_matmul_f32(x, packed, cb, nbits=nbits),
                                 lut_matmul_f32_ref(x, packed, cb, nbits=nbits),
                                 float(x.float().norm(dim=1).max())))
                q = torch.randint(-128, 128, (m, kp), generator=gen, dtype=torch.int8,
                                  device=dev)
                act = torch.tensor(0.03, device=dev)
                runs.append(("lut_matmul_int8", "int8",
                             lut_matmul_int8(q, packed, cb, act, nbits=nbits),
                             lut_matmul_int8_ref(q, packed, cb, act, nbits=nbits),
                             0.03 * float(q.float().norm(dim=1).max())))
                # B7 on q == B2 / B1 (ops wrappers, s_q included) on x, bit for bit
                x = torch.randn((m, kp), generator=gen, device=dev)
                inv = 1.0 / ((0.5 + torch.rand(kp, generator=gen, device=dev)) * 0.03)
                qq = torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
                same = bool(torch.equal(lut_gemm_int8(qq, packed, cb, act, nbits=nbits),
                                        lut_gemm_fused(x, inv, packed, cb, act,
                                                       quantize=True, nbits=nbits)))
                torch.cuda.synchronize()
                for name, dt, y, ref, xmax in runs:
                    # |y - ref| <= 1e-5 * max_m ||x_m|| * max_n ||w_n|| (f32 sums of
                    # K terms taken in another order)
                    tol = 1e-5 * xmax * wmax
                    err = float((y - ref).abs().max())
                    case = dict(kernel=name, m=m, k=k, n=n, nbits=nbits, dtype=dt,
                                max_abs_err=err, tol=tol)
                    if name == "lut_matmul_int8":
                        case["equals_fused_gemm_bits"] = same
                    if not (bool(torch.isfinite(y).all()) and err <= tol) or not same:
                        fail.append(case)
                    worst[name] = max(worst[name], err)
                    cases.append(case)
    for (m, c) in ((8, 4096), (256, 4096), (8, 11008), (256, 11008), (5, 37), (3, 4100)):
        for bits in (8, 4):
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn((m, c), generator=gen, device=dev) * 150).to(dtype)
                inv = 0.5 + torch.rand(c, generator=gen, device=dev)
                q = smooth_quant(x, inv, bits=bits)
                ref = smooth_quant_ref(x, inv, bits)
                torch.cuda.synchronize()
                lo = -(1 << (bits - 1))
                case = dict(kernel="smooth_quant", m=m, c=c, bits=bits,
                            dtype=str(dtype).split(".")[-1], equal=bool(torch.equal(q, ref)),
                            saturated_low=int((q == lo).sum()), max_abs_err=0.0)
                if not case["equal"] or (m * c > 1000 and case["saturated_low"] == 0):
                    fail.append(case)
                cases.append(case)
    if fail:
        emit("kernels", failed=fail[:5])
        raise SystemExit(f"a §4 layer kernel disagrees with its plain version: {fail[:2]}")
    # times: B6 / B7 at the projection shapes, B10 at the activation shapes
    for name in names[:2]:
        for (k, n) in LLAMA_KN:
            for m in (8, 256):
                case = dict(kernel=name, m=m, k=k, n=n, nbits=4,
                            dtype="int8" if name == "lut_matmul_int8" else "float32")
                case.update(_time_plain(gen, name, m, k, n, 4))
                cases.append(case)
                if (m, k, n) == (256, 4096, 11008):
                    headline[name] = case
    # 4096 x 4096: where a launch no longer costs about what the bytes do
    for (m, c) in ((8, 4096), (256, 4096), (8, 11008), (256, 11008), (4096, 4096)):
        rows = max(m, math.ceil(64e6 / (c * 4)) // m * m)     # > L2: cold activations
        x = torch.randn((rows, c), generator=gen, device=dev)
        inv = 0.5 + torch.rand(c, generator=gen, device=dev)
        reps = rows // m
        nbytes = m * c * 4 + c * 4 + m * c
        case = dict(kernel="smooth_quant", m=m, c=c, bits=8, dtype="float32",
                    ms=time_ms(lambda i: smooth_quant(x[(i % reps) * m:(i % reps + 1) * m],
                                                      inv), 4 * reps),
                    plain_ms=time_ms(lambda i: smooth_quant_ref(
                        x[(i % reps) * m:(i % reps + 1) * m], inv), 3, warmup=1),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        cases.append(case)
        if (m, c) == (256, 4096):
            headline["smooth_quant"] = case
    return cases, worst, headline


# ---------------------------------------------------------------------------
# the attention kernels B8 (gathered int8 view) and B9 (flash), and the
# library yardstick timed beside them
# ---------------------------------------------------------------------------

def _attention_close(out, ref):
    """(ok, max |out - ref|, the worst ratio of an element's error to its
    limit) for an attention output against its plain version on the same
    inputs. f32 is held to the reference's 2e-5. bf16 is held per element:
    both sides round an f32 result to bf16, so an element may differ by one
    bf16 ulp, at most 2^-7 |ref|, plus 2^-7 rms(ref) for elements near zero.
    A flat limit would be as large as a typical output: at Sk = 4096 most
    rows average thousands of values and |out| is about 0.04."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        lim = torch.full_like(err, 2e-5)
    else:
        r = ref.float()
        lim = 2.0 ** -7 * (r.abs() + r.square().mean().sqrt())
    ratio = float((err / lim).max())
    ok = bool(torch.isfinite(out.float()).all()) and out.dtype == ref.dtype and ratio <= 1.0
    return ok, float(err.max()), ratio


def _sdpa_yardstick_ms(q, k, v, *, is_causal=False, attn_mask=None, iters=10) -> float:
    """Milliseconds of one PyTorch library attention call on (B, H, S, D)
    operands: the yardstick beside B8 and B9, timed here and used nowhere in
    the port."""
    f = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda i: f(q, k, v, attn_mask=attn_mask, is_causal=is_causal), iters)


def _dequant_case(gen, t, h, kv, qdtype, window, d=128):
    """An int8 block pool at llama2-7b's engine shape (`EngineConfig` of the
    serve phase: 8 slots, 32 blocks of 16 per slot, so L = 512), its view
    gathered through random block tables, random lengths <= L - T, an idle
    slot, a slot with no new tokens and one with n_new < T."""
    from repro_torch.models.layers import quantize_kv
    dev = gen.device
    s, bs, nb, nbw = 8, 16, 256, 32
    l = nbw * bs
    host = torch.Generator().manual_seed(7 * t + h)
    lengths = torch.randint(0, l - t + 1, (s,), generator=host, dtype=torch.int32)
    n_new = torch.full((s,), t, dtype=torch.int32)
    lengths[2], n_new[2] = 0, 0                        # idle: nothing visible
    n_new[5] = 0                                       # cached tokens, none new
    n_new[6] = max(t // 2, 1)
    tables = torch.randperm(nb, generator=host)[:s * nbw].reshape(s, nbw).to(torch.int32)
    ksm = 0.5 + torch.rand((kv, d), generator=gen, device=dev)
    vsm = 0.5 + torch.rand((kv, d), generator=gen, device=dev)
    kp, ks = quantize_kv(torch.randn((nb, bs, kv, d), generator=gen, device=dev), ksm)
    vp, vs = quantize_kv(torch.randn((nb, bs, kv, d), generator=gen, device=dev), vsm)
    kp, ks, vp, vs = (x.contiguous() for x in (kp, ks, vp, vs))
    q = torch.randn((s, t, h, d), generator=gen, device=dev).to(qdtype)
    tables, lengths, n_new = tables.to(dev), lengths.to(dev), n_new.to(dev)

    def view(pool):
        return pool[tables.long()].reshape(s, l, *pool.shape[2:]).contiguous()

    dq = (q, view(kp), view(ks), view(vp), view(vs), ksm, vsm, lengths, n_new, window)
    pool = ((q, kp, vp, tables, lengths, n_new, window),
            dict(k_scale=ks, v_scale=vs, k_smooth=ksm, v_smooth=vsm))
    # what this data needs: for a slot with new tokens, the K and V codes and
    # scales of the keys its queries can see (length + n_new, narrowed by the
    # window) and the q / out rows of its new tokens
    seen = rows = 0
    for a, b in zip(lengths.tolist(), n_new.tolist()):
        if b:
            seen += a + b - (max(0, a - window + 1) if window > 0 else 0)
            rows += b
    nbytes = (2 * seen * kv * (d + 4) + 2 * kv * d * 4 + 2 * rows * h * d * q.element_size()
              + 2 * s * 4)
    bound = dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return dq, pool, bound


def check_dequant_attention(gen):
    """B8 against its plain version at llama2-7b's engine shape (H = KV = 32)
    and qwen2-1.5b's GQA (12 heads over 2), D 128, L 512, T in {1, 32}, with a
    window of 64 and a softcap of 50; B8 on the gathered view torch.equal to
    B5 on the pool, and l_pad 128 torch.equal to l_pad 256. Then the
    instances for a D other than 128 (D / 32 read at run time) at D 32 and
    256, under the same checks (at D 256, l_pad 64 against 128)."""
    from repro_torch.kernels.paged_attention import (paged_dequant_attention,
                                                     paged_pool_attention)
    from repro_torch.kernels.ref import paged_dequant_attention_ref
    cases, worst = [], 0.0
    shapes = [(128, t, hk, qdtype, window, softcap)
              for t in (1, 32) for hk in ((32, 32), (12, 2))
              for qdtype in (torch.bfloat16, torch.float32)
              for window, softcap in ((0, 0.0), (64, 0.0), (0, 50.0))]
    shapes += [(d, t, (32, 32), qdtype, window, softcap)
               for d in (32, 256) for t in (1, 32)
               for qdtype in (torch.bfloat16, torch.float32)
               for window, softcap in ((0, 0.0), (64, 50.0))]
    for d, t, (h, kv), qdtype, window, softcap in shapes:
        dq, (pa, pkw), _ = _dequant_case(gen, t, h, kv, qdtype, window, d=d)
        # two stages: 128 and 256 keys, or 64 and 128 where D = 256 (256 keys of
        # D 256 overflow the shared memory, pool_plan)
        l_pads = (128, 256) if d <= 128 else (64, 128)
        out = paged_dequant_attention(*dq, softcap=softcap, l_pad=l_pads[0])
        out2 = paged_dequant_attention(*dq, softcap=softcap, l_pad=l_pads[1])
        pool = paged_pool_attention(*pa, softcap=softcap, **pkw)
        ref = paged_dequant_attention_ref(*dq, softcap=softcap)
        torch.cuda.synchronize()
        # as for B5: f32 rows differ by f32 rounding; bf16 elements by
        # one ulp each (_attention_close)
        if qdtype == torch.float32:
            tol = 5e-5 * max(float(ref.abs().max()), 1.0)
            err = float((out - ref).abs().max())
            close, ratio = err <= tol, err / tol
        else:
            tol = "2^-7 (|ref| + rms(ref)) per element"
            close, err, ratio = _attention_close(out, ref)
        case = dict(kernel="paged_dequant_attention", t=t, h=h, kv=kv, d=d,
                    q=str(qdtype).split(".")[-1], window=window, softcap=softcap,
                    max_abs_err=err, tol=tol, err_over_limit=ratio,
                    equals_pool_attention_bits=bool(torch.equal(out, pool)),
                    l_pads=l_pads, l_pad_bits_equal=bool(torch.equal(out, out2)),
                    idle_slot_zero=bool((out[2] == 0).all()))
        if not (bool(torch.isfinite(out.float()).all()) and close
                and case["equals_pool_attention_bits"]
                and case["l_pad_bits_equal"] and case["idle_slot_zero"]):
            emit("kernels", failed=case)
            raise SystemExit(f"paged_dequant_attention disagrees: {case}")
        worst = max(worst, err)
        cases.append(case)
    return cases, worst


# B9's shapes: llama2-7b's prefill attention (one sequence x 32 heads, 4096
# tokens, D 128), its gemma2-style masks, a decode window and a padded cache
FLASH_CASES = (
    ("prefill causal", dict(bh=32, sq=4096, sk=4096, dtype=torch.bfloat16), {}),
    ("window 1024 softcap 50", dict(bh=32, sq=4096, sk=4096, dtype=torch.bfloat16),
     dict(window=1024, softcap=50.0)),
    ("decode window", dict(bh=32, sq=128, sk=4096, dtype=torch.bfloat16),
     dict(q_offset=3968)),
    ("padded cache k_len 3000", dict(bh=32, sq=4096, sk=4096, dtype=torch.bfloat16),
     dict(k_len=3000)),
    ("f32 causal", dict(bh=32, sq=1024, sk=1024, dtype=torch.float32), {}),
    # at the heuristic tile (256, 512) the window is narrower than bk: a row's
    # first step can be all masked (the finite -1e30 keeps it NaN-free)
    ("f32 window 256 softcap 30", dict(bh=32, sq=1024, sk=1024, dtype=torch.float32),
     dict(window=256, softcap=30.0)),
    ("f32 non-causal", dict(bh=32, sq=256, sk=1024, dtype=torch.float32),
     dict(causal=False)),
)


def _flash_operands(gen, bh, sq, sk, dtype, d=128):
    return [torch.randn((bh, s, d), generator=gen, device=gen.device).to(dtype)
            for s in (sq, sk, sk)]


def _flash_bound(bh, sq, sk, d, dtype, causal=True, window=0, q_offset=0, k_len=0):
    """max(bytes of q, k, v and out once over the memory rate, 4 * D
    operations per visible (query, key) pair over the peak of the type)."""
    qp = q_offset + np.arange(sq, dtype=np.int64)
    klim = min(k_len, sk) if k_len > 0 else sk
    kmin = np.maximum(0, qp - window + 1) if window > 0 else np.zeros_like(qp)
    kmax = np.minimum(qp if causal else sk - 1, klim - 1)
    pairs = int(np.maximum(kmax - kmin + 1, 0).sum()) * bh
    elt = torch.empty((), dtype=dtype).element_size()
    t_b = (2 * bh * sq * d + 2 * bh * sk * d) * elt / HBM_BYTES_PER_S
    t_o = 4.0 * d * pairs / PEAK_OPS[dtype]
    return dict(bound_ms=max(t_b, t_o) * 1e3, bound_by="bytes" if t_b >= t_o else "operations",
                visible_pairs=pairs)


def check_flash_attention(gen):
    """B9 against its plain version at every FLASH_CASES shape: at the bf16
    prefill and the f32 causal case every (bq, bk) the tuner may pick, so each
    rows-per-pass variant of the kernel is held at f32's 2e-5 too; elsewhere
    the heuristic and the smallest tile. f32 within 2e-5, bf16 per element
    (_attention_close)."""
    from repro_torch.kernels.autotune import flash_candidates, flash_heuristic
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    cases, worst = [], 0.0
    for name, shape, kw in FLASH_CASES:
        q, k, v = _flash_operands(gen, shape["bh"], shape["sq"], shape["sk"], shape["dtype"])
        ref = flash_attention_ref(q, k, v, **kw)
        tiles = (flash_candidates(shape["sq"], shape["sk"])
                 if name in ("prefill causal", "f32 causal")
                 else [flash_heuristic(shape["sq"], shape["sk"]), (64, 128)])
        tol = (2e-5 if shape["dtype"] == torch.float32
               else "2^-7 (|ref| + rms(ref)) per element")
        for bq, bk in tiles:
            out = flash_attention(q, k, v, bq=bq, bk=bk, **kw)
            torch.cuda.synchronize()
            close, err, ratio = _attention_close(out, ref)
            case = dict(kernel="flash_attention", case=name, bq=bq, bk=bk,
                        dtype=str(shape["dtype"]).split(".")[-1], max_abs_err=err, tol=tol,
                        err_over_limit=ratio, **{x: shape[x] for x in ("bh", "sq", "sk")}, **kw)
            if not close:
                emit("kernels", failed=case)
                raise SystemExit(f"flash_attention disagrees with its plain version: {case}")
            if name == "prefill causal":
                # device time of every tile of the tuner's grid (the tuner itself
                # times on the host's clock)
                case["ms"] = time_ms(lambda i: flash_attention(q, k, v, bq=bq, bk=bk, **kw), 5,
                                     warmup=1)
            worst = max(worst, err)
            cases.append(case)
        del q, k, v, ref
    return cases, worst


# ---------------------------------------------------------------------------
# the attention kernels' tuner
# ---------------------------------------------------------------------------

def phase_autotune(seed: int):
    """The path that runs B8 and B9: their public entry points with the tile
    left as None, as the reference's wrappers run on a compiled backend. On a
    fresh cache file each call measures every candidate tile through the
    kernel and runs the winner; called again, the wrappers measure nothing
    and give the same outputs; the cache reloaded from its JSON file, again
    nothing. Returns (launch counts of the path, B8 / B9 headline rows)."""
    import tempfile

    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.kernels.paged_attention import paged_dequant_attention
    from repro_torch.kernels.ref import flash_attention_ref, paged_dequant_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    flash_calls = {"prefill causal": FLASH_CASES[0], "decode window": FLASH_CASES[2]}
    flash_ops = {n: _flash_operands(gen, c[1]["bh"], c[1]["sq"], c[1]["sk"], c[1]["dtype"])
                 for n, c in flash_calls.items()}
    dequant_calls = {"llama2-7b T=1": (1, 32, 32), "llama2-7b T=32": (32, 32, 32),
                     "qwen2-1.5b T=32": (32, 12, 2)}
    dequant_ops = {n: _dequant_case(gen, t, h, kv, torch.bfloat16, 0)
                   for n, (t, h, kv) in dequant_calls.items()}

    def run_path():
        outs = {}
        for n, (q, k, v) in flash_ops.items():
            outs["flash " + n] = flash_attention(q, k, v, **flash_calls[n][2])
        for n, (dq, _, _) in dequant_ops.items():
            outs["paged " + n] = paged_dequant_attention(*dq)
        torch.cuda.synchronize()
        return outs

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        cache = autotune.reset_cache(path)
        reset_launch_counts()
        t0 = time.perf_counter()
        first = run_path()
        tune_s = time.perf_counter() - t0
        counts = launch_counts()
        measured = dict(cache.measured)
        again = run_path()
        hit_measured = {v: cache.measured[v] - measured[v] for v in measured}
        reloaded_cache = autotune.reset_cache(path)    # as a new process would read it
        reloaded = run_path()
        reload_measured = dict(reloaded_cache.measured)
    autotune.reset_cache()

    tuned, whole = {}, True
    for key, log in cache.log.items():
        variant, _, geom, _ = key.split("|")
        m, k, n = (int(x[1:]) for x in geom.split(","))
        cands = (autotune.flash_candidates(m, k) if variant == "flash"
                 else autotune.paged_candidates(k))
        us = {"x".join(map(str, c)): round(t, 2) for c, t in log["us"].items()}
        winner = tuple(cache.entries[key]["blocks"])
        whole &= (set(log["us"]) | set(log["refused"]) == {tuple(c) for c in cands}
                  and bool(log["us"]) and winner == min(log["us"], key=log["us"].get))
        tuned[key] = dict(candidates_us=us, winner="x".join(map(str, winner)),
                          refused={"x".join(map(str, c)): why
                                   for c, why in log["refused"].items()})
    same_hit = all(torch.equal(first[n], again[n]) for n in first)
    same_reload = all(torch.equal(first[n], reloaded[n]) for n in first)
    ok = (whole and same_hit and same_reload and len(tuned) == len(first)
          and not any(hit_measured.values()) and not any(reload_measured.values())
          and all(bool(torch.isfinite(o.float()).all()) for o in first.values())
          and counts["flash_attention"] > 0 and counts["paged_dequant_attention"] > 0)

    # outputs of the tuned path against the plain versions
    errs, ratios = {}, {}
    for n, (q, k, v) in flash_ops.items():
        close, errs["flash " + n], ratios["flash " + n] = _attention_close(
            first["flash " + n], flash_attention_ref(q, k, v, **flash_calls[n][2]))
        ok &= close
    for n, (dq, _, _) in dequant_ops.items():
        close, errs["paged " + n], ratios["paged " + n] = _attention_close(
            first["paged " + n], paged_dequant_attention_ref(*dq))
        ok &= close

    # times at the winning tiles (after the counts were read: these launches
    # are not the path's)
    heads = {}
    backend = autotune.backend_name("cuda")
    q, k, v = flash_ops["prefill causal"]
    bq, bk = cache.entries[autotune.normalize_key(4096, 4096, 128, 0, "flash",
                                                  backend)]["blocks"]
    heads["flash_attention"] = dict(
        case="prefill causal", bh=32, sq=4096, sk=4096, d=128, dtype="bfloat16", bq=bq, bk=bk,
        ms=time_ms(lambda i: flash_attention(q, k, v, bq=bq, bk=bk), 5, warmup=1),
        plain_ms=time_ms(lambda i: flash_attention_ref(q, k, v), 3, warmup=1),
        library_ms=_sdpa_yardstick_ms(q[None], k[None], v[None], is_causal=True),
        **_flash_bound(32, 4096, 4096, 128, torch.bfloat16))
    heads["flash_attention"]["heuristic_ms"] = time_ms(
        lambda i: flash_attention(q, k, v, bq=256, bk=512), 5, warmup=1)
    # the decode window (128 rows at positions 3968.. over 4096 keys) at its
    # tuned tile, beside the library attention given the same mask as a tensor
    q, k, v = flash_ops["decode window"]
    kw = flash_calls["decode window"][2]
    bq, bk = cache.entries[autotune.normalize_key(128, 4096, 128, 0, "flash",
                                                  backend)]["blocks"]
    qp = kw["q_offset"] + torch.arange(128, device="cuda")
    mask = qp[:, None] >= torch.arange(4096, device="cuda")[None, :]
    heads["flash_attention"]["decode_window"] = dict(
        bh=32, sq=128, sk=4096, d=128, q_offset=kw["q_offset"], dtype="bfloat16", bq=bq, bk=bk,
        ms=time_ms(lambda i: flash_attention(q, k, v, bq=bq, bk=bk, **kw), 20, warmup=1),
        plain_ms=time_ms(lambda i: flash_attention_ref(q, k, v, **kw), 3, warmup=1),
        library_ms=_sdpa_yardstick_ms(q[None], k[None], v[None], attn_mask=mask),
        **_flash_bound(32, 128, 4096, 128, torch.bfloat16, q_offset=kw["q_offset"]))
    dq, _, bound = dequant_ops["llama2-7b T=1"]
    l_pad = cache.entries[autotune.normalize_key(1, 512, 128, 8, "paged", backend)]["blocks"][0]
    # the yardstick: the library attention over the view dequantized to bf16
    # beforehand, the same mask as a boolean tensor
    qd, kq, ks, vq, vs, ksm, vsm, lengths, n_new, _ = dq
    kd = (kq.float() * ks[..., None] * ksm).to(torch.bfloat16).transpose(1, 2)
    vd = (vq.float() * vs[..., None] * vsm).to(torch.bfloat16).transpose(1, 2)
    cols = torch.arange(512, device="cuda")
    mask = (cols[None, :] < (lengths + n_new)[:, None])[:, None, None, :]
    heads["paged_dequant_attention"] = dict(
        case="llama2-7b T=1", s=8, t=1, h=32, kv=32, d=128, l=512, dtype="bfloat16",
        l_pad=l_pad,
        ms=time_ms(lambda i: paged_dequant_attention(*dq, l_pad=l_pad), 50),
        plain_ms=time_ms(lambda i: paged_dequant_attention_ref(*dq), 5, warmup=1),
        sdpa_dense_bf16_ms=_sdpa_yardstick_ms(qd.transpose(1, 2), kd, vd, attn_mask=mask,
                                              iters=50),
        **bound)
    emit("autotune", tuned=tuned, tune_s=round(tune_s, 2), measured=measured,
         measured_on_hit=hit_measured, measured_after_reload=reload_measured,
         outputs_equal_on_hit=same_hit, outputs_equal_after_reload=same_reload,
         every_admissible_candidate_measured=whole, launches=counts,
         max_abs_err_vs_plain=errs, err_over_limit=ratios, timed=heads)
    if not ok:
        raise SystemExit("autotune: the tuned attention path is wrong")
    return counts, heads


def phase_kernels(seed: int):
    from repro_torch.kernels.ops import launch_counts
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lut_cases, lut_worst, lut_head = check_lut_kernels(gen)
    multi_cases, multi_worst, multi_head = check_multi_kernels(gen)
    edge_cases, edge_worst = check_gemv_edges(gen)
    lut_worst["lut_matmul_fused_gemv"] = max(lut_worst["lut_matmul_fused_gemv"], edge_worst)
    att_cases, att_worst, att_head = check_attention_kernel(gen)
    t_independent = _attn_row_bits_do_not_depend_on_t(gen)
    verify_rows = _attn_verify_rows_match_t1(gen)
    plain_cases, plain_worst, plain_head = check_plain_kernels(gen)
    dq_cases, dq_worst = check_dequant_attention(gen)
    fa_cases, fa_worst = check_flash_attention(gen)
    fam_cases, fam_worst = check_family_kernels(gen)
    for worsts in (lut_worst, multi_worst):
        for name in worsts:
            worsts[name] = max(worsts[name], fam_worst.get(name, 0.0))
    att_worst = max(att_worst, fam_worst.get("paged_pool_attention", 0.0))
    every = lut_cases + multi_cases + edge_cases + att_cases + plain_cases + dq_cases + fa_cases
    # B8 / B9: per kernel and dtype, the cases held and the worst ratio of an
    # element's error to its limit (_attention_close; B8 f32: 5e-5 * scale)
    held = {}
    for c in dq_cases + fa_cases:
        key = f'{c["kernel"]} {c.get("dtype", c.get("q"))}'
        n, r = held.get(key, (0, 0.0))
        held[key] = (n + 1, max(r, c["err_over_limit"]))
    emit("kernels", compared=len(every),
         attention_cases_worst_err_over_limit=held,
         worst_abs_err={**lut_worst, **multi_worst, "paged_pool_attention": att_worst,
                        **plain_worst, "paged_dequant_attention": dq_worst,
                        "flash_attention": fa_worst},
         paged_pool_attention_row_bits_same_at_t1_and_t2_to_32=len(t_independent),
         paged_pool_attention_verify_rows_same_as_t1=verify_rows,
         launches_during_comparison=launch_counts(), timed=[c for c in every if "ms" in c])
    # the rest of the family on a line of its own: the kernels line is already long
    emit("kernels_family", compared=len(fam_cases), worst_abs_err=fam_worst,
         paged_pool_attention_row_bits_same_at_t1_and_t32=[
             dict(arch=c["arch"], d=c["d"], row0_equal=c["row0_equal"])
             for c in fam_cases if "row0_equal" in c],
         cases=fam_cases)
    out = {name: (lut_head[name], lut_worst[name]) for name in lut_head}
    out.update({name: (multi_head[name], multi_worst[name]) for name in multi_head})
    out["paged_pool_attention"] = (att_head, att_worst)
    out.update({name: (plain_head[name], plain_worst[name]) for name in plain_head})
    out["paged_dequant_attention"] = ({}, dq_worst)
    out["flash_attention"] = ({}, fa_worst)
    return out


# ---------------------------------------------------------------------------
# the paper's §4 LUT layer at llama2-7b's gate_proj width
# ---------------------------------------------------------------------------

def phase_lut_layer(seed: int) -> dict:
    """examples/serve_lut.py layer_demo at llama2-7b's gate_proj width, port
    only: 256 calibration tokens x 4096 with an outlier channel, W 4096 x
    11008; offline adaptive_smooth -> fold_into_weight -> kmeans_1d(12) ->
    assign -> build_lut_layer; online smooth_quant_input (B10) ->
    lut_gemm_int8 (B7) at M = 256 and M = 8, and the float-activation
    variant x/s -> lut_gemm (B6). Returns the launch counts of that online
    run (counts set to 0 just before it)."""
    from repro_torch.core import clustering as C
    from repro_torch.core.lut import build_lut_layer, pack_codes_torch
    from repro_torch.core.smoothing import (adaptive_smooth, fold_into_weight,
                                            smooth_quant_input)
    from repro_torch.kernels.ops import (launch_counts, lut_gemm, lut_gemm_int8,
                                         pad_codebook, reset_launch_counts)
    from repro_torch.kernels.ref import lut_matmul_int8_ref, smooth_quant_ref

    d_in, d_out, n_tok = 4096, 11008, 256
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n_tok, d_in)).astype(np.float32)
    x[:, 7] *= 30                      # activation outlier channel (the LLM pathology)
    w = torch.from_numpy(rng.normal(0, 0.04, (d_in, d_out)).astype(np.float32)).cuda()
    t0 = time.perf_counter()
    sres = adaptive_smooth(x)
    ws = fold_into_weight(w, sres.s)
    cents = C.kmeans_1d(ws, 12)
    st = C.make_state(cents, device="cuda")
    slot_codes = C.assign(ws, st)
    remap = torch.zeros(C.K_MAX, dtype=torch.int32, device="cuda")
    remap[torch.nonzero(st.active).reshape(-1)] = torch.arange(
        int(st.k), dtype=torch.int32, device="cuda")
    codes = remap.index_select(0, slot_codes.reshape(-1)).reshape(slot_codes.shape)
    layer = build_lut_layer(ws, codes.to(torch.uint8).cpu().numpy(),
                            C.active_centroids(st), sres.s, x)
    packed = pack_codes_torch(codes, 4)
    torch.cuda.synchronize()
    offline_s = time.perf_counter() - t0

    s_t = torch.from_numpy(layer.smooth).cuda()
    cb = torch.from_numpy(layer.codebook).cuda()
    act = torch.tensor(layer.act_scale, dtype=torch.float32, device="cuda")
    xt = torch.from_numpy(x).cuda()
    y_fp = xt @ w
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = {}
    for m in (256, 8):
        q = smooth_quant_input(xt[:m], s_t, act)
        y = lut_gemm_int8(q, packed, cb, act)
        y_f = lut_gemm(xt[:m] / s_t, packed, cb)
        outs[m] = (q, y, y_f)
    torch.cuda.synchronize()
    counts = launch_counts()

    rows, ok = {}, True
    inv = (1.0 / (s_t * act)).contiguous()
    w_norm = float(cb[codes.long()].norm(dim=0).max())
    for m, (q, y, y_f) in outs.items():
        ref_q = smooth_quant_ref(xt[:m], inv)
        ref_y = lut_matmul_int8_ref(q, packed, pad_codebook(cb), act)
        rel = float((y - y_fp[:m]).norm() / y_fp[:m].norm())
        rel_f = float((y_f - y_fp[:m]).norm() / y_fp[:m].norm())
        err = float((y - ref_y).abs().max())
        # f32 sums of K terms taken in another order, as in the kernels phase
        tol = 1e-5 * float(act) * float(q.float().norm(dim=1).max()) * w_norm
        x_s = (xt[:m] / s_t).contiguous()
        rows[str(m)] = dict(
            rel_err_int8_path=rel, rel_err_float_path=rel_f, demo_limit=0.3,
            codes_equal_plain=bool(torch.equal(q, ref_q)), max_abs_err_vs_plain=err,
            transform_ms=time_ms(lambda i: smooth_quant_input(xt[:m], s_t, act), 50),
            lut_gemm_int8_ms=time_ms(lambda i: lut_gemm_int8(q, packed, cb, act), 20),
            lut_gemm_float_ms=time_ms(lambda i: lut_gemm(x_s, packed, cb), 20))
        rows[str(m)].update(tol=tol, demo_bound_holds=rel < 0.3)
        # the int8 codes may cost little over the float activations; the
        # demo's 0.3 holds at its own 512 x 256 only (ROADMAP C), so it is
        # reported, and the error the weights' clustering leaves is not a fault
        ok &= (rel <= rel_f + 0.02 and rows[str(m)]["codes_equal_plain"]
               and bool(torch.isfinite(y).all()) and err <= tol)
    dense_bytes = d_in * d_out * 2                       # bf16 weights
    lut_bytes = packed.numel() + layer.codebook.size * 4
    emit("lut_layer", d_in=d_in, d_out=d_out, calib_tokens=n_tok, smoothing=sres.kind,
         centroids=layer.n_centroids, act_scale=layer.act_scale,
         offline_s=round(offline_s, 3), by_m=rows, launches=counts,
         weight_bytes_dense_bf16=dense_bytes, weight_bytes_packed=lut_bytes,
         compression=round(dense_bytes / lut_bytes, 2))
    if not ok:
        raise SystemExit(f"lut_layer: the §4 layer is wrong: {rows}")
    return counts


# ---------------------------------------------------------------------------
# LCD compression on the card
# ---------------------------------------------------------------------------

def _slice_of(ct, l):
    from repro_torch.core.api import map_arrays
    return map_arrays(ct, lambda a: a[l])


# the compress phase's depth: llama2-7b cut to 1 layer (2 -> 1 for the 820 s
# mark when every family came to train on a mesh: four compressions of a
# layer's 7 slices each, ~10 s a compression at 2 layers)
COMPRESS_LAYERS = 1


def phase_compress(seed: int) -> None:
    """llama2-7b at full width (d_model 4096, d_ff 11008, 32 heads), COMPRESS_LAYERS,
    dense bf16 weights from the seed on the card, through compress_model:
    at 8 centroids / 4 bits (seconds per slice, centroids per slice, relative
    weight error), again (the packed bytes must repeat), under a 3.0 bits
    budget, and inside build_engine(lcd=True), whose engine then serves 8
    staggered requests that must decode alike alone. Last, one 512 x 512
    slice compressed on the card and on the CPU."""
    import dataclasses

    from repro_torch.core import api
    from repro_torch.core.api import (_flatten_with_paths, clustered_dequant,
                                      compress_model, is_clustered)
    from repro_torch.launch.engine import EngineConfig, ServingEngine, build_engine
    from repro_torch.models.config import get_config
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=COMPRESS_LAYERS)
    model = get_model(cfg)
    dense = model.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")

    slice_s = []                        # (shape, seconds) per distilled slice
    inner = api.distill_layer_to_k

    def timed_to_k(w, *a, **kw):
        t = time.perf_counter()
        out = inner(w, *a, **kw)
        torch.cuda.synchronize()
        slice_s.append((tuple(w.shape), time.perf_counter() - t))
        return out

    api.distill_layer_to_k = timed_to_k
    try:
        t0 = time.perf_counter()
        p1, r1 = compress_model(dense, target_centroids=8, nbits=4)
        torch.cuda.synchronize()
        total1 = time.perf_counter() - t0
        per_slice = list(slice_s)
        t0 = time.perf_counter()
        p2, _ = compress_model(dense, target_centroids=8, nbits=4)
        torch.cuda.synchronize()
        total2 = time.perf_counter() - t0
        t0 = time.perf_counter()
        p3, r3 = compress_model(dense, target_centroids=8, bits_budget=3.0)
        torch.cuda.synchronize()
        total3 = time.perf_counter() - t0
    finally:
        api.distill_layer_to_k = inner

    leaves1 = dict(_flatten_with_paths(p1))
    leaves2 = dict(_flatten_with_paths(p2))
    dense_leaves = dict(_flatten_with_paths(dense))
    same_bytes = all(torch.equal(leaves1[p].packed, leaves2[p].packed)
                     and torch.equal(leaves1[p].codebook, leaves2[p].codebook)
                     for p in r1.bits_assignment)
    errs, ks = {}, {}
    for p in r1.bits_assignment:
        ct, w = leaves1[p], dense_leaves[p].float()
        errs[p] = [float((clustered_dequant(_slice_of(ct, l)) - w[l]).norm() / w[l].norm())
                   for l in range(w.shape[0])]
        ks[p] = [len(r1.per_layer[f"{p}[{l}]"].final_centroids) for l in range(w.shape[0])]
    mean_err = float(np.mean([e for v in errs.values() for e in v]))

    # the engine compresses the same dense weights itself, then serves
    ecfg = EngineConfig(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=256,
                        max_blocks_per_slot=32)
    t0 = time.perf_counter()
    engine, served = build_engine("llama2-7b", use_reduced=False, lcd=True, ecfg=ecfg,
                                  params=dense, n_layers=COMPRESS_LAYERS, device="cuda")
    engine_build_s = time.perf_counter() - t0
    leaves_e = dict(_flatten_with_paths(served))
    engine_same_bytes = all(torch.equal(leaves_e[p].packed, leaves1[p].packed)
                            for p in r1.bits_assignment)
    prompts = _serve_prompts(cfg.vocab, seed, 8)
    requests = _drive(engine, prompts, 16)
    tokens = [list(r.out_tokens) for r in requests]
    solo_same = {}
    for rid, prompt in enumerate(prompts):
        solo = ServingEngine(engine.model, served, ecfg, device="cuda")
        r = solo.submit(prompt, max_new_tokens=16)
        solo.run()
        solo_same[rid] = r.out_tokens == tokens[rid]
        del solo

    # one slice on the card and on the CPU
    w512 = dense["blocks"]["attn"]["wq"][0, :512, :512].float().contiguous()
    pc, _ = compress_model({"w": w512}, target_centroids=8)
    pcpu, _ = compress_model({"w": w512.cpu()}, target_centroids=8, device="cpu")
    codes_c, codes_h = pc["w"].codes.long().cpu(), pcpu["w"].codes.long()
    differ = int((codes_c != codes_h).sum())
    detail = {}
    if differ:
        # each differing weight's distance to the midpoint of its two codes
        cb = pcpu["w"].codebook
        i = torch.nonzero(codes_c != codes_h)[:8]
        ws = w512.cpu()[i[:, 0], i[:, 1]]
        a, b = cb[codes_c[i[:, 0], i[:, 1]]], cb[codes_h[i[:, 0], i[:, 1]]]
        detail = dict(weight_to_midpoint=(ws - (a + b) / 2).abs().tolist(),
                      codebook_max_abs_diff=float((pc["w"].codebook.cpu() - cb).abs().max()))

    budget_ok = r3.mean_packed_bits <= 3.0 + 1e-9
    all_clustered = all(is_clustered(leaves1[p]) for p in r1.bits_assignment)
    emit("compress", arch="llama2-7b", layers=COMPRESS_LAYERS, d_model=cfg.d_model,
         d_ff=cfg.d_ff,
         n_heads=cfg.n_heads, dtype=cfg.dtype, target_centroids=8, nbits=4,
         seconds_total=round(total1, 3), seconds_again=round(total2, 3),
         seconds_per_slice=[dict(shape=list(sh), s=round(t, 3)) for sh, t in per_slice],
         centroids_per_slice=ks, rel_weight_err_mean=mean_err,
         rel_weight_err_per_slice={p: [round(e, 5) for e in v] for p, v in errs.items()},
         packed_bytes_repeat=same_bytes, summary=r1.summary(),
         bits_budget=dict(budget=3.0, seconds=round(total3, 3),
                          assignment=r3.bits_assignment,
                          mean_packed_bits=r3.mean_packed_bits),
         engine=dict(build_s=round(engine_build_s, 3), same_bytes_as_compress=engine_same_bytes,
                     requests=len(requests), new_tokens_each=16,
                     solo_redecode_same_tokens=solo_same, traces=dict(engine.traces)),
         slice_512_card_vs_cpu=dict(codes_differ=differ, **detail))
    if not (same_bytes and engine_same_bytes and all_clustered and budget_ok
            and mean_err < 0.3 and all(solo_same.values())
            and all(len(t) == 16 for t in tokens)):
        raise SystemExit("compress: compression or the engine on its output is wrong")


# ---------------------------------------------------------------------------
# model parity and serving
# ---------------------------------------------------------------------------

ACT_SCALE = {"wq": 0.04, "wk": 0.04, "wv": 0.04, "wo": 0.01,
             "w_gate": 0.04, "w_up": 0.04, "w_down": 0.03,
             # the recurrent families' projections (rwkv6's r / g, zamba2's mamba)
             "wr": 0.04, "wg": 0.04, "w_in": 0.04, "w_out": 0.03}


def calibrate(params):
    """Install a calibrated-looking activation scale on every clustered leaf,
    so the kernels run the quantized Eq. 11 transform, not the float one."""
    from repro_torch.core.api import is_clustered

    def walk(tree, name=""):
        if is_clustered(tree):
            # dense_to_clustered's arithmetic: act_scale = s_q per (stacked)
            # tensor, inv_scale = 1/(s_m*s_q) per input channel
            s_m, s_q = tree.smooth.to(torch.float32), ACT_SCALE[name]
            return tree._replace(
                inv_scale=1.0 / (s_m * s_q),
                act_scale=torch.full(s_m.shape[:-1], s_q, dtype=torch.float32,
                                     device=s_m.device))
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree
    return walk(params)


def to_device(tree, device):
    from repro_torch.core.api import is_clustered, map_arrays
    if is_clustered(tree):
        return map_arrays(tree, lambda a: a.to(device))
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


PLAIN_LUT = ("lut_matmul_fused", "lut_matmul_fused_gemv", "lut_matmul_fused_multi",
             "lut_matmul_fused_multi_gemv")


@contextlib.contextmanager
def _plain_versions():
    """Inside, the serving path and `forward` run the plain versions of the
    kernels they reach (B1-B4 through `kernels/ops.py`, B5 through
    `models/layers.py`) on the card's tensors: nothing is launched, nothing
    counted."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (lut_matmul_fused_multi_ref, lut_matmul_fused_ref,
                                         paged_pool_attention_ref)
    from repro_torch.models import layers

    def solo(x, inv, pk, cb, *, quantize, nbits):
        return lut_matmul_fused_ref(x, inv, pk, cb, 1.0, quantize=quantize, nbits=nbits)

    def multi(x, inv, cb, *pks, quantize, nbits):
        return torch.cat(lut_matmul_fused_multi_ref(x, inv, list(pks), cb, [1.0] * len(pks),
                                                    quantize=quantize, nbits=nbits), dim=1)

    def attention(q, k_pool, v_pool, block_tables, lengths, n_new, window, **kw):
        return paged_pool_attention_ref(q, k_pool, v_pool, block_tables, lengths, n_new,
                                        int(window), **kw)
    plain = [(ops, n, multi if "multi" in n else solo) for n in PLAIN_LUT]
    plain.append((layers, "paged_pool_attention", attention))
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in plain]
    for mod, n, f in plain:
        setattr(mod, n, f)
    try:
        yield
    finally:
        for mod, n, f in saved:
            setattr(mod, n, f)


def _parity_diagnosis(logits, diff) -> dict:
    """What a miss of model_parity prints: both sides' top-5 logits of the
    worst row."""
    worst = divmod(int(diff.amax(dim=-1).argmax()), diff.shape[1])    # (step, row)
    sides = {}
    for side, lg in logits.items():
        top = lg[worst].topk(5)
        sides[side] = dict(values=top.values.tolist(), indices=top.indices.tolist())
    return dict(worst_step_row=list(worst), worst_row_max_abs_err=float(diff[worst].max()),
                top5=sides)


def _parity_row(logits, tol_max, tol_mean, clear_margin=0.12, **meta):
    """model_parity's verdict on kernels-vs-plain logits: max and mean
    |dlogit| within their limits, finite, and the same argmax wherever the
    plain side's top-2 margin is clear of `clear_margin`."""
    diff = (logits["kernels"] - logits["plain"]).abs()
    top2 = logits["plain"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > clear_margin
    same = logits["kernels"].argmax(-1) == logits["plain"].argmax(-1)
    row = dict(meta, max_abs_logit_err=float(diff.max()), tol_max=tol_max,
               mean_abs_logit_err=float(diff.mean()), tol_mean=tol_mean,
               argmax_agreement=float(same.float().mean()), rows=same.numel(),
               rows_with_clear_margin=int(clear.sum()), clear_margin=clear_margin,
               logit_abs_max=float(logits["plain"].abs().max()),
               logit_std=float(logits["plain"].std()))
    row["ok"] = (bool(torch.isfinite(logits["kernels"]).all())
                 and row["max_abs_logit_err"] <= tol_max
                 and row["mean_abs_logit_err"] <= tol_mean
                 and bool(same[clear].all()) and int(clear.sum()) > 0)
    if not row["ok"]:
        row["diagnosis"] = _parity_diagnosis(logits, diff)
    return row


def phase_model_parity(seed: int) -> None:
    """llama2-7b at full width: the same params and the same steps (one
    prefill chunk, two decode steps) through the kernels and through their
    plain versions (`_plain_versions`), both on the card. Three times: in
    float32 with the float transform (2 layers) and with the quantized Eq. 11
    transform (1 layer), where the two sides differ by the order of f32 sums,
    and in the serving configuration (bf16, quantized transform, 2 layers).
    There an activation that lands on the other side of a rounding boundary
    moves a whole output row by s_q * centroid, so single logits lie further
    apart than bf16 rounding alone would put them; the greedy token must
    still be the same wherever the plain side's top-2 margin is clear of
    that noise.

    The plain side runs on the card, not on the CPU: this random 2-layer
    model magnifies last-bit differences between f32 kernels, and the CPU's
    f32 logits change with the CPU kernels ATen picks for the host
    (ATEN_CPU_CAPABILITY). On one host they missed the 1e-3 limit by 2.7x
    (2.72e-3), while the card's top logits matched the CPU's of every other
    host."""
    import dataclasses

    from repro_torch.core.clustered_params import materialize_clustered
    from repro_torch.models.config import get_config
    from repro_torch.models.registry import get_model

    s, t, nbw, nb, bs = 8, 32, 8, 64, 16
    rng = np.random.default_rng(seed)
    tables = rng.permutation(nb)[:s * nbw].reshape(s, nbw).astype(np.int32)
    n_first = rng.integers(5, t + 1, s).astype(np.int32)
    n_first[3] = 0                                         # an idle slot
    active = n_first > 0
    vocab = get_config("llama2-7b").vocab
    steps = [(rng.integers(0, vocab, (s, t)).astype(np.int32), n_first)]
    for _ in range(2):
        steps.append((rng.integers(0, vocab, (s, 1)).astype(np.int32),
                      active.astype(np.int32)))

    # (dtype, quantized transform, layers, max |dlogit| allowed, mean |dlogit| allowed)
    variants = (("float32", False, 2, 1e-3, 1e-4), ("float32", True, 1, 5e-3, 5e-4),
                ("bfloat16", True, 2, 0.75, 0.03))
    clear_margin = 0.12          # 4 x the mean limit of the bf16 variant
    report = []
    for dtype, quantized, n_layers, tol_max, tol_mean in variants:
        cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=n_layers, dtype=dtype)
        model = get_model(cfg)
        params = materialize_clustered(model, torch.Generator().manual_seed(seed),
                                       nbits=4, device="cpu")
        if quantized:
            params = calibrate(params)
        logits = {}
        p = to_device(params, "cuda")
        for side in ("kernels", "plain"):
            caches = model.init_seq_caches(num_blocks=nb, block_size=bs, num_slots=s,
                                           max_seq=nbw * bs, kv_dtype="float", device="cuda")
            lengths = np.zeros(s, np.int32)
            outs = []
            for tokens, n_new in steps:
                args = [torch.from_numpy(a).cuda() for a in (tokens, lengths, n_new, tables)]
                if side == "plain":
                    with _plain_versions():
                        lg, caches = model.serving_step(p, caches, *args)
                else:
                    # the step itself must not wait for the host: any
                    # synchronising call inside it raises while this mode is on
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        lg, caches = model.serving_step(p, caches, *args)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                outs.append(lg[active][:, :vocab].float().cpu())
                lengths = lengths + n_new
            logits[side] = torch.stack(outs)
            del caches
        del p
        report.append(_parity_row(logits, tol_max, tol_mean, clear_margin, dtype=dtype,
                                  quantized_transform=quantized, layers=n_layers))
    emit("model_parity", arch="llama2-7b", steps=len(steps), variants=report)
    if not all(r["ok"] for r in report):
        raise SystemExit(f"model_parity: the kernels' and the plain versions' logits "
                         f"disagree: {report}")


def _frames_of(engine, prompt, salt=0):
    """An encoder-decoder model's (whisper's) frames for a prompt: (1,
    enc_seq, d_model) normal values drawn on the card from a seed hashed
    from the prompt's tokens (and `salt`), so a prompt resubmitted (a solo
    run, a check on the same engine) brings the same frames; None for every
    other model."""
    from repro_torch.models.registry import CAP_ENCODER
    if not engine.model.supports(CAP_ENCODER):
        return None
    cfg = engine.model.cfg
    tokens = np.ascontiguousarray(prompt, np.int32)
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(tokens.tobytes()) + salt)
    return torch.randn((1, cfg.enc_seq, cfg.d_model), generator=gen, device="cuda")


def _submit(engine, prompt, new_tokens):
    """`engine.submit`, with the prompt's frames where the model has an
    encoder (`_frames_of`)."""
    return engine.submit(prompt, max_new_tokens=new_tokens,
                         frames=_frames_of(engine, prompt))


def _drive(engine, prompts, new_tokens):
    """Staggered submissions: a fresh request every other scheduler step,
    counted from the drive's first step."""
    pending = list(prompts)
    requests = []
    start = engine.steps
    while pending or engine.busy:
        if pending and (engine.steps - start) % 2 == 0:
            requests.append(_submit(engine, pending.pop(0), new_tokens))
        if engine.busy:
            engine.step()
        else:
            engine.steps += 1
    return requests


def _served_params(arch, seed, n_layers, fused=True, dtype=None, quantized=True):
    """(model, params): LCD 4-bit weights from `seed` on the card
    (`materialize_clustered`, in the config's dtype unless `dtype` is
    given), with the quantized Eq. 11 transform armed unless `quantized` is
    False. An encoder-decoder arch (whisper) gets `n_layers` encoder layers
    too, and its layernorm scales drawn near one
    (`_layernorm_scales_near_one`). gla's forget-gate LoRA (`gate_A`, `gate_B`) is drawn dense, as
    materialize_clustered draws a dense leaf (normal(0, 0.02), f32):
    clustered it cannot run, in the JAX package either (ROADMAP C)."""
    import dataclasses

    from repro_torch.core.clustered_params import materialize_clustered
    from repro_torch.models.config import get_config
    from repro_torch.models.registry import get_model
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, fused_projections=fused)
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, n_enc_layers=n_layers)     # as deep as the decoder
    model = get_model(cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = materialize_clustered(model, gen, nbits=4, device="cuda")
    if model.cfg.family == "audio":
        params = _layernorm_scales_near_one(params, gen)
    if model.cfg.family == "linear_attn":
        attn = params["blocks"]["attn"]
        for name in ("gate_A", "gate_B"):
            shape = tuple(attn[name].smooth.shape) + (attn[name].codes.shape[-1],)
            attn[name] = torch.randn(shape, generator=gen, device="cuda") * 0.02
    return model, (calibrate(params) if quantized else params)


def _layernorm_scales_near_one(params, gen):
    """`params` with every layernorm scale (a dict holding "scale" and
    "bias") drawn as 1 + 0.1 normal instead of materialize_clustered's
    normal(0, 0.02): whisper's layernorm multiplies by its scale (no 1 +
    scale, unlike the RMS norms), and a stream scaled by 0.02 at every norm
    would leave the logits near zero, where no greedy token is clear."""
    if isinstance(params, dict) and {"scale", "bias"} <= set(params):
        sc = params["scale"]
        return {**params, "scale": 1.0 + 0.1 * torch.randn(
            sc.shape, generator=gen, device=sc.device, dtype=torch.float32).to(sc.dtype)}
    if isinstance(params, dict):
        return {k: _layernorm_scales_near_one(v, gen) for k, v in params.items()}
    return params


# the §4 layer's kernels, the attention kernels B8, B9 and the projection's
# backward kernels: never launched by a serving step
NOT_SERVING = {"lut_matmul_f32": 0, "lut_matmul_int8": 0, "smooth_quant": 0,
               "paged_dequant_attention": 0, "flash_attention": 0, "split_bf16": 0,
               "lut_matmul_t": 0, "lut_codebook_grad": 0}


def _mlp_kind(cfg):
    """What a layer's MLP launches: "moe" (no LUT launch: the experts are
    resolved by `layers.resolve_weight` and multiplied by plain products, as
    in the JAX package), else the dense MLP's kind."""
    return "moe" if cfg.n_experts else cfg.mlp


def _lut_launches_per_layer(fused, mlp="swiglu"):
    """(multi, solo) LUT launches of one layer's step: the SwiGLU MLP's
    layer runs 2 multi launches (QKV, gate+up) and 2 solo (wo, w_down)
    fused, 7 solo unfused; the gelu MLP has no gate, so its layer runs one
    multi launch (QKV) and 3 solo (wo, w_up, w_down) fused, 6 solo unfused;
    an MoE layer's LUT launches are its attention's: one multi (QKV) and
    one solo (wo) fused, 4 solo unfused."""
    n = {"swiglu": 7, "gelu": 6, "moe": 4}[mlp]
    if not fused:
        return 0, n
    return {"swiglu": (2, 2), "gelu": (1, 3), "moe": (1, 1)}[mlp]


def _expected_launches(fused, n_layers, widths, mlp="swiglu"):
    """LUT and attention launches of the engine's steps
    (`_lut_launches_per_layer`), one attention launch per layer and step."""
    w32, w1 = widths.get(32, 0), widths.get(1, 0)
    per = _lut_launches_per_layer(fused, mlp)
    return {"lut_matmul_fused_multi_gemv": per[0] * n_layers * w1,
            "lut_matmul_fused_multi": per[0] * n_layers * w32,
            "lut_matmul_fused_gemv": per[1] * n_layers * w1,
            "lut_matmul_fused": per[1] * n_layers * w32,
            "paged_pool_attention": n_layers * (w1 + w32), **NOT_SERVING}


@contextlib.contextmanager
def _no_host_sync():
    """Inside, any call that synchronises the host with the card raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _clone_pools(engine):
    """Clones of every cache of the engine (the paged pool, the slot state)
    and, in speculative mode, of the draft's (None otherwise), keyed by kind
    as `engine.caches` is; a mesh's pool (`MeshTree`) as a clone of every
    distinct part."""
    from repro_torch.distributed.placement import MeshTree

    def cl(cache):
        if isinstance(cache, MeshTree):
            return cache.clone()
        return {k: v.clone() for k, v in cache.items()}
    return [None if c is None else {kind: cl(cache) for kind, cache in c.items()}
            for c in (engine.caches, engine.draft_caches)]


def _pools_differ(engine, clones):
    """Names ("kind/name", the draft's prefixed) of the cache tensors that
    differ from `clones` (on a mesh, "kind/part i")."""
    from repro_torch.distributed.placement import MeshTree
    bad = []
    for tag, c, clone in (("", engine.caches, clones[0]), ("draft ", engine.draft_caches,
                                                         clones[1])):
        if c is None:
            continue
        for kind, cache in c.items():
            if isinstance(cache, MeshTree):
                bad += [f"{tag}{kind}/part {i}" for i, (a, b) in enumerate(
                    zip(cache.tensors(), clone[kind].tensors())) if not torch.equal(a, b)]
            else:
                bad += [f"{tag}{kind}/{k}" for k, v in cache.items()
                        if not torch.equal(v, clone[kind][k])]
    return bad


def _verify_rows_check(engine, buf, drafts, wide_pool, step_pool, seen):
    """Row j of one width-(k+1) verify's logits against the j-th of k+1
    width-1 `serving_step` calls, on two clones of the target pool taken
    before the round, for every slot in the round: torch.equal, and the two
    pools equal afterwards. What speculative tokens = plain greedy tokens
    rests on."""
    k, model, params = engine.spec_k, engine.model, engine.params
    pend, lengths, n_one, tables = engine._unpack(buf, 1)
    tokens = torch.cat([pend, drafts], dim=1)
    with torch.no_grad():
        wide, _ = model.serving_verify(params, {"paged": wide_pool}, tokens, lengths,
                                       n_one * (k + 1), tables)
        live = [s for s in range(tokens.shape[0]) if int(n_one[s].cpu())]
        for j in range(k + 1):
            one, _ = model.serving_step(params, {"paged": step_pool}, tokens[:, j:j + 1].contiguous(),
                                        lengths + j * n_one, n_one, tables)
            for s in live:
                seen["verify_rows_compared"] += 1
                if not torch.equal(wide[s, j], one[s]):
                    seen["verify_row_misses"].append(dict(
                        step=engine.steps, slot=s, row=j,
                        max_abs_diff=float((wide[s, j] - one[s]).abs().max())))
    from repro_torch.distributed.placement import MeshTree
    if isinstance(wide_pool, MeshTree):
        bad = [f"part {i}" for i, (a, b) in enumerate(zip(wide_pool.tensors(),
                                                          step_pool.tensors()))
               if not torch.equal(a, b)]
    else:
        bad = [k for k in wide_pool if not torch.equal(wide_pool[k], step_pool[k])]
    if bad:
        seen["verify_row_misses"].append(dict(step=engine.steps, pools_differ=bad))


def _graph_check(name, engine, seed, prompt_lens=(40, 23, 70, 33)):
    """The engine's step graphs against their eager bodies
    (`ServingEngine._step_body`, and in speculative mode `_draft_body` and
    `_verify_body`, what each graph captured), step by step with new data in
    the same buffers: a fresh staggered drive on the engine whose graphs the
    phase captured, with idle slots, new lengths and block tables every step,
    decoding slots that grow by a block, and one request preempted
    (recompute) and re-admitted. Before every step (or speculative round) the
    caches (the paged pools, the slot state), the draft's too, are cloned;
    the eager bodies run the same upload over the clones, with any host
    synchronisation an error; the tokens and every cache tensor must be
    torch.equal. The preemption is a snapshot where the family keeps one
    (rwkv6, gla: its restore runs between two replays); a slot-state family
    grows no blocks.
    In speculative mode every round also holds the verify's rows to width-1
    steps (`_verify_rows_check`), except for an MoE model: its layers route
    all rows of a step together under a capacity, so a verify row is not a
    width-1 step's row there, in the JAX package either. Fails the run on a
    miss, or when a graph was never replayed or the drive lacked block
    growth or a re-admission."""
    graphs = engine._graphs
    spec = engine.spec_k > 0
    rows_checked = spec and not engine.model.cfg.n_experts
    seen = dict(replays={}, warm_ups={}, misses=[], idle_slot_steps=0, grown=0, readmitted=0)
    if rows_checked:
        seen.update(verify_rows_compared=0, verify_row_misses=[])

    def checked(tokens, n_new):
        t = tokens.shape[1]
        label = "prefill" if spec else t
        kind = "replays" if engine._shape_key(t) in graphs.capture_seconds() else "warm_ups"
        seen[kind][label] = seen[kind].get(label, 0) + 1
        seen["idle_slot_steps"] += int((n_new == 0).any())
        before = _clone_pools(engine)
        buf = np.empty(engine._upload_len(t), np.int32)
        engine._pack(buf, tokens, n_new)
        got = engine_step(tokens, n_new)
        buf = torch.from_numpy(buf).cuda()
        with _no_host_sync():
            want = engine._step_body(before[0], buf, t, before[1])
        want = want.cpu().numpy()
        bad = _pools_differ(engine, before)
        if not np.array_equal(got, want) or bad:
            seen["misses"].append(dict(step=engine.steps, width=t, tokens=got.tolist(),
                                       eager_tokens=want.tolist(), pools_differ=bad))
        return got

    def checked_round(pend, n_one):
        kind = "replays" if ("draft", engine.spec_k) in graphs.capture_seconds() else "warm_ups"
        seen[kind]["round"] = seen[kind].get("round", 0) + 1
        seen["idle_slot_steps"] += int((n_one == 0).any())
        before = _clone_pools(engine)
        rows_pools = _clone_pools(engine)[0]["paged"], _clone_pools(engine)[0]["paged"]
        buf = np.empty(engine._upload_len(1), np.int32)
        engine._pack(buf, pend, n_one)
        buf = torch.from_numpy(buf).cuda()
        got = engine_round(pend, n_one)
        with _no_host_sync():
            drafts = engine._draft_body(before[1], buf)
            want = engine._verify_body(before[0], buf, drafts)
        want = want.cpu().numpy()
        bad = _pools_differ(engine, before)
        if not np.array_equal(got, want) or bad:
            seen["misses"].append(dict(step=engine.steps, round=True, tokens=got.tolist(),
                                       eager_tokens=want.tolist(), pools_differ=bad))
        if rows_checked:
            _verify_rows_check(engine, buf, drafts, *rows_pools, seen)
        return got

    engine_step, engine_round = engine._model_step, engine._model_round
    engine._model_step = checked
    if spec:
        engine._model_round = checked_round
    try:
        rng = np.random.default_rng(seed + 7)
        cfg = engine.model.cfg
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]
        pending, requests, evicted = list(prompts), [], None
        while pending or engine.busy:
            if pending and engine.steps % 2 == 0:
                requests.append(_submit(engine, pending.pop(0), 20))
            if not engine.busy:
                engine.steps += 1
                continue
            decoding = {r.rid: len(r.blocks) for r in requests
                        if r.state == "running" and not r.prefilling}
            if evicted is None:
                victim = next((r for r in requests if r.rid in decoding
                               and len(r.out_tokens) >= 3), None)
                if victim is not None:
                    # recompute preemption; a snapshot where the family keeps one
                    engine.preempt(victim)
                    evicted = victim
            engine.step()
            seen["grown"] += sum(r.state == "running" and len(r.blocks) > decoding[r.rid]
                                 for r in requests if r.rid in decoding)
        seen["readmitted"] = int(evicted is not None and evicted.state == "finished"
                                 and evicted.preemptions == 1)
    finally:
        engine.__dict__.pop("_model_step", None)
        engine.__dict__.pop("_model_round", None)
    graphs_of = ("prefill", "round") if spec else (1, engine.ecfg.prefill_chunk)
    ok = (not seen["misses"] and (seen["grown"] > 0 or not engine.has_paged)
          and seen["readmitted"] == 1
          and seen["idle_slot_steps"] > 0
          and all(seen["replays"].get(w, 0) > 0 for w in graphs_of)
          and all(r.state == "finished" and len(r.out_tokens) == 20 for r in requests)
          and not (rows_checked and (seen["verify_row_misses"]
                                     or not seen["verify_rows_compared"])))
    emit("graph", engine=name, arch=cfg.arch_id, layers=cfg.n_layers, ok=ok,
         steps_compared=sum(seen["replays"].values())
         + sum(seen["warm_ups"].values()), **seen)
    if not ok:
        raise SystemExit(f"graph: {name}: a replay differs from the eager body, or the drive "
                         f"missed a case: {seen}")


def _step_ms(engine, seed):
    """A prefill-width step and a decode step of `engine` with all 8 slots
    busy (8 prompts of 128 tokens): host-clock ms per step and the CUDA-event
    span per step over 2 and 8 steps (`_wall_ms_per_step`, profiler off), and
    the device ms of one replay of the width's graph (`_replay_ms`: the last
    upload again, the same writes)."""
    cfg = engine.model.cfg
    rng = np.random.default_rng(seed + 13)
    for _ in range(engine.ecfg.num_slots):
        engine.submit(rng.integers(0, cfg.vocab, 128).astype(np.int32), max_new_tokens=16)
    out = {}
    engine.step()
    for key, width, n in (("prefill_width_32", 32, 2), ("decode_width_1", 1, 8)):
        ran = engine.traces.get(width, 0)
        wall, span = _wall_ms_per_step(engine, n)
        if engine.traces.get(width, 0) - ran != n or any(r is None for r in engine.slots):
            raise SystemExit(f"step times: {key}: not every step was of width {width} with "
                             f"all 8 slots busy")
        out[key] = dict(steps=n, wall_ms_per_step=round(wall, 3),
                        event_span_ms_per_step=round(span, 3),
                        device_ms_per_replay=round(_replay_ms(engine._graphs._graphs[width]), 3))
        while any(r is not None and r.prefilling for r in engine.slots):
            engine.step()
    engine.run()
    return out


def _serve(name, arch, seed, n_layers, n_requests, new_tokens, kv_dtype, solo_ids,
           fused=True, params=None, want_tokens=None, step_times=False, after_drive=None,
           mesh=None, want_name="fused", report=None):
    """The engine at full width: staggered requests, launch counts per model
    step, engine-vs-solo token identity for `solo_ids` (each alone on the
    drive's engine once it is idle, one after another) and, with `want_tokens`,
    token identity with another configuration's run (`want_name`'s); with
    `step_times`, the step times of `_step_ms` on the same engine; with
    `after_drive`, its checks on the same engine after the graph check
    (after_drive(engine, prompts, tokens) -> a list of failures). With
    `mesh`, the engine serves on it: every rank launches its kernels, so a
    dense arch cut on every projection and kv head launches each kernel
    mesh.size times as often. `report`, when given, receives the line's
    fields."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import EngineConfig, build_engine

    ecfg = EngineConfig(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=256,
                        max_blocks_per_slot=32, kv_dtype=kv_dtype)
    if params is None:
        _, params = _served_params(arch, seed, n_layers, fused)
    t0 = time.perf_counter()
    engine, _ = build_engine(arch, use_reduced=False, lcd=True, ecfg=ecfg, seed=seed,
                             params=params, fused_projections=fused, n_layers=n_layers,
                             device="cuda", mesh=mesh)
    build_s = time.perf_counter() - t0
    if kv_dtype == "int8" and mesh is None:      # calibrated by build_engine, on the card
        pool = engine.caches["paged"]
        if all(bool((pool[k] == 1.0).all()) for k in ("k_smooth", "v_smooth")):
            raise SystemExit(f"{name}: the int8 pool kept identity smoothing vectors")
    cfg = engine.model.cfg
    prompts = _serve_prompts(cfg.vocab, seed, n_requests)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    requests = _drive(engine, prompts, new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    engine.assert_bounded_traces()
    widths = dict(engine.traces)
    model_steps = sum(widths.values())
    n_tok = sum(len(r.out_tokens) for r in requests)
    if cfg.family in RECURRENT_FAMILIES:
        expected = _recurrent_expected_launches(cfg, widths)
        path = RECURRENT_PATH[cfg.family]
    elif cfg.family == "audio":
        expected = _audio_expected_launches(cfg, widths)
        path = AUDIO_PATH
    else:
        expected = _expected_launches(fused, n_layers, widths, _mlp_kind(cfg))
        path = [n for n in expected if fused and n not in NOT_SERVING]
    if mesh is not None:
        expected = {n: c * mesh.size for n, c in expected.items()}
    ok = (all(r.state == "finished" and len(r.out_tokens) == new_tokens for r in requests)
          and all(0 <= tok < cfg.vocab for r in requests for tok in r.out_tokens)
          and counts == expected and all(expected[n] > 0 for n in path))

    capture_s = {str(w): round(c, 3) for w, c in engine._graphs.capture_seconds().items()}
    # the host's seconds of each stage after the drive
    stage_s, t0 = {}, time.perf_counter()

    def stage(key):
        nonlocal t0
        torch.cuda.synchronize()
        stage_s[key] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
    # every replay against the eager body, on the engine whose graphs this drive
    # captured. A recurrent family's step is T passes of the stack, and its
    # eager prefill-width step takes ~4 s on the host: two requests, one
    # prefill chunk and two (the state carried from chunk to chunk), the
    # first preempted and re-admitted (rwkv6 / gla restore its snapshot,
    # zamba2 recomputes one chunk), both growing by a block in zamba2's pool
    _graph_check(name, engine, seed, **(dict(prompt_lens=(14, 36))
                                        if cfg.family in RECURRENT_FAMILIES else {}))
    stage("graph_check")
    steps_ms = _step_ms(engine, seed) if step_times else None
    tokens = [list(r.out_tokens) for r in requests]
    after = after_drive(engine, prompts, tokens) if after_drive is not None else []
    stage("step_times_and_after_drive")
    # engine-vs-solo token identity: each request alone on the drive's engine,
    # idle by now, one after another
    solo_same = {}
    for rid in solo_ids:
        r = _submit(engine, prompts[rid], new_tokens)
        engine.run()
        solo_same[rid] = r.out_tokens == tokens[rid]
    stage("solo")
    del engine
    row = dict(arch=arch, layers=n_layers, dtype=cfg.dtype, weight_bits=4,
               kv_dtype=kv_dtype or "float", fused_projections=fused, requests=n_requests,
               new_tokens_each=new_tokens, prompt_lens=[len(p) for p in prompts],
               model_steps=model_steps, step_widths={str(w): c for w, c in widths.items()},
               tokens_generated=n_tok, wall_s=round(wall, 3),
               tokens_per_s=round(n_tok / wall, 2), launches=counts,
               launches_expected=expected, solo_redecode_same_tokens=solo_same,
               preemptions=sum(r.preemptions for r in requests),
               engine_build_s=round(build_s, 3), graph_capture_s=capture_s,
               seconds_after_drive=stage_s,
               peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    if cfg.family == "audio":
        row["launches_by_shape"] = _audio_launches_by_shape(cfg, widths)
    if steps_ms is not None:
        row["step_ms_8_slots_busy"] = steps_ms
    if want_tokens is not None:
        row[f"same_tokens_as_{want_name}"] = tokens == want_tokens
    if mesh is not None:
        row["mesh"] = mesh.shape
    if report is not None:
        report.update(row)
    emit(name, **row)
    if not ok:
        raise SystemExit(f"{name}: launch counts or outputs are wrong: {counts} vs "
                         f"{expected}, model steps {model_steps}")
    if not all(solo_same.values()):
        raise SystemExit(f"{name}: engine tokens differ from solo decoding: {solo_same}")
    if want_tokens is not None and tokens != want_tokens:
        raise SystemExit(f"{name}: tokens differ from the {want_name} configuration's")
    if after:
        raise SystemExit(f"{name}: {after}")
    return counts, tokens


def _cloned(tree):
    """A copy of every tensor of a parameter tree (ClusteredTensor fields too)."""
    from repro_torch.core.api import is_clustered, map_arrays
    if is_clustered(tree):
        return map_arrays(tree, lambda a: a.clone())
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    return tree.clone()


def _first_layers(params, n):
    """The first `n` layers of a stacked parameter tree: views, nothing copied."""
    from repro_torch.core.api import is_clustered, map_arrays

    def cut(tree):
        if is_clustered(tree):
            return map_arrays(tree, lambda a: a[:n])
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]
    return {**params, "blocks": cut(params["blocks"])}


# ---------------------------------------------------------------------------
# serving on a (data, model) mesh of one card
# ---------------------------------------------------------------------------

# the meshes the logits check (32 layers) and the serve drive run on; every
# coordinate is cuda:0 (one card). The serve drive runs at MESH_DRIVE_LAYERS
# (cut from 32 for the script's time limit: `serve` is the dense family's
# full-depth drive), held to a 1 x 1 engine of the same depth
MESH_SHAPES = ((1, 2), (2, 1))
MESH_DRIVE_LAYERS = 4
SERVE_ECFG = dict(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=256,
                  max_blocks_per_slot=32)
MESH_PATH = PLAIN_LUT + ("paged_pool_attention",)


def _mesh_of(shape):
    """A (data, model) mesh of `shape` whose every coordinate is cuda:0."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"), [torch.device("cuda", 0)] * (shape[0] * shape[1]))


def _whole_caches(engine):
    """Every cache tensor of the engine (the paged pool, the slot state) as a
    whole tensor, keyed "kind/name": on a mesh, each leaf's parts
    concatenated on their cut dim."""
    from repro_torch.distributed.placement import MeshTree
    out = {}
    for kind, cache in engine.caches.items():
        if not isinstance(cache, MeshTree):
            out.update({f"{kind}/{name}": t for name, t in cache.items()})
            continue
        for name, leaf in cache.views[0].items():
            out[f"{kind}/{name}"] = (leaf.parts[0] if leaf.dim is None
                                     else torch.cat(leaf.parts, dim=leaf.dim))
    return out


def _next_decode_logits(engine):
    """The logits of the engine's next width-1 step (every running slot
    feeds its last token), through the eager body on clones of its caches."""
    s = engine.ecfg.num_slots
    tokens, n_new = np.zeros((s, 1), np.int32), np.zeros(s, np.int32)
    for i, r in enumerate(engine.slots):
        if r is not None:
            tokens[i, 0], n_new[i] = r.out_tokens[-1], 1
    args = engine._unpack(engine._host_upload(tokens, n_new), 1)
    with torch.no_grad(), _no_host_sync():
        logits, _ = engine.model.serving_step(engine.params, _clone_pools(engine)[0], *args)
    return logits


def _serve_prompts(vocab, seed, n):
    """`n` prompts of 40-200 tokens, from `seed` (`_serve`'s and the other
    drives')."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(40, 201))).astype(np.int32)
            for _ in range(n)]


def _lockstep_prompts(vocab, seed):
    """The mesh logits check's prompts: one of 40-120 tokens a slot, from
    `seed` + 21."""
    rng = np.random.default_rng(seed + 21)
    return [rng.integers(0, vocab, int(rng.integers(40, 121))).astype(np.int32)
            for _ in range(SERVE_ECFG["num_slots"])]


def _step_until_decoding(engine):
    """Step `engine` (at most 64 steps) until every slot decodes."""
    for _ in range(64):
        if all(r is not None and not r.prefilling and r.out_tokens for r in engine.slots):
            break
        engine.step()


def _lockstep_drive(engine, prompts, new_tokens, timed=False):
    """`prompts` submitted at once on `engine` and stepped until every slot
    decodes, where the next decode step's logits (through the eager body on
    clones of the caches) and every cache as whole tensors are taken; then
    run to the end. Returns (logits, caches, counts, tokens) and the drive's
    launches; `timed` adds a third item, the drive's decode step times
    (`_drive_decode_ms`)."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    reqs = [_submit(engine, p, new_tokens) for p in prompts]
    _step_until_decoding(engine)
    seen = dict(steps=engine.steps,
                slots_decoding=sum(r is not None and not r.prefilling for r in engine.slots),
                cached_tokens=int(engine.lengths.sum()))
    logits = _next_decode_logits(engine)
    caches = {k: v.clone() for k, v in _whole_caches(engine).items()}
    times = _drive_decode_ms(engine) if timed else None
    engine.run()
    torch.cuda.synchronize()
    tokens = [list(r.out_tokens) for r in reqs]
    launched = {n: c for n, c in launch_counts().items() if c}
    if timed:
        # after the drive: a replay writes the caches again
        times["device_ms_per_replay"] = round(_replay_ms(engine._graphs._graphs[1], n=10), 3)
        return (logits, caches, seen, tokens), launched, times
    return (logits, caches, seen, tokens), launched


def _drive_decode_ms(engine):
    """A decode step of a drive with all 8 slots decoding: one step (the
    width-1 graph's capture if it has none yet), then host-clock ms per step
    and the CUDA-event span per step over 4 steps (profiler off)."""
    engine.step()
    ran = engine.traces.get(1, 0)
    wall, span = _wall_ms_per_step(engine, 4)
    if engine.traces.get(1, 0) - ran != 4 or any(r is None or r.prefilling
                                                 for r in engine.slots):
        raise SystemExit("mesh family decode ms: not every step was of width 1 with all "
                         "8 slots decoding")
    return dict(wall_ms_per_step=round(wall, 3), event_span_ms_per_step=round(span, 3))


def _lockstep_logits(engine, seed):
    """The mesh logits check's 8 prompts (40-120 tokens, 6 new) through
    `_lockstep_drive`: (logits, caches, counts)."""
    prompts = _lockstep_prompts(engine.model.cfg.vocab, seed)
    return _lockstep_drive(engine, prompts, 6)[0][:3]


def _mesh_logits_check(model, params, seed, mesh, want):
    """`_lockstep_logits` on an engine over `mesh` against `want`, its run
    on the 1 x 1 engine: the next decode step's logits torch.equal, and the
    mesh's caches, their parts gathered, torch.equal to the 1 x 1 caches, at
    the same step with every slot decoding."""
    from repro_torch.launch.engine import EngineConfig, ServingEngine
    engine = ServingEngine(model, params, EngineConfig(**SERVE_ECFG), mesh=mesh, device="cuda")
    got, caches, seen = _lockstep_logits(engine, seed)
    one, one_caches, one_seen = want
    out = dict(logits_equal=bool(torch.equal(one, got)),
               max_abs_diff=float((one.float() - got.float()).abs().max()),
               caches_equal=all(torch.equal(one_caches[k], caches[k]) for k in one_caches),
               **seen)
    if seen != one_seen or seen["slots_decoding"] != SERVE_ECFG["num_slots"]:
        out["logits_equal"] = False        # the same step, with every slot decoding
    return out


def _shard_ct(gen, k, n):
    """A 4-bit (k, n) ClusteredTensor from `gen`, quantized transform armed."""
    from repro_torch.core.api import ClusteredTensor
    from repro_torch.core.lut import packed_rows
    dev = gen.device
    packed = torch.randint(0, 255, (packed_rows(k, 4), n), generator=gen,
                           dtype=torch.uint8, device=dev)
    cb = torch.sort(torch.randn((16,), generator=gen, device=dev) * 0.02).values
    smooth = 0.5 + torch.rand((k,), generator=gen, device=dev)
    return ClusteredTensor(codes=packed, codebook=cb, smooth=smooth, packed=packed,
                           inv_scale=1.0 / (smooth * 0.04),
                           act_scale=torch.tensor(0.04, device=dev), nbits=4)


def _column_part(w, r, parts):
    """Model rank r's column shard of a (K, N) ClusteredTensor cut in `parts`."""
    n = w.codes.shape[-1] // parts
    return w._replace(codes=w.codes[:, r * n:(r + 1) * n].contiguous(),
                      packed=w.packed[:, r * n:(r + 1) * n].contiguous())


def _columns_equal(gen, m, k, n, parts):
    """B1 / B2 (`clustered_linear`) on each column shard against its slice of
    the full launch, bf16 activations at M = m."""
    from repro_torch.kernels.ops import clustered_linear
    w = _shard_ct(gen, k, n)
    x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
    full = clustered_linear(x, w)
    c = n // parts
    return all(torch.equal(clustered_linear(x, _column_part(w, r, parts)),
                           full[:, r * c:(r + 1) * c]) for r in range(parts))


def _multi_columns_equal(gen, m, k, widths, parts):
    """B3 / B4 (`clustered_linear_multi`) on each rank's column shards of
    every projection against their slices of the full launch."""
    from repro_torch.kernels.ops import clustered_linear_multi
    ws = [_shard_ct(gen, k, n) for n in widths]
    x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
    full = clustered_linear_multi(x, ws)
    ok = True
    for r in range(parts):
        got = clustered_linear_multi(x, [_column_part(w, r, parts) for w in ws])
        ok &= all(torch.equal(g, f[:, r * (f.shape[1] // parts):(r + 1) * (f.shape[1] // parts)])
                  for g, f in zip(got, full))
    return bool(ok)


def _heads_equal(gen, t, h, kv, pool, d, parts):
    """B5 on each rank's kv heads (with the query heads of their groups)
    against its slice of the full launch."""
    from repro_torch.kernels.paged_attention import paged_pool_attention
    args, kw, _ = _attn_case(gen, t, h, kv, torch.bfloat16, pool, 0, 0.0, d=d)
    full = paged_pool_attention(*args, **kw)
    q, kp, vp, rest = args[0], args[1], args[2], args[3:]
    hq, hk = h // parts, kv // parts
    ok = True
    for r in range(parts):
        sq, sk = slice(r * hq, (r + 1) * hq), slice(r * hk, (r + 1) * hk)
        kw_r = {key: (v[..., sk].contiguous() if key in ("k_scale", "v_scale")
                      else v[sk].contiguous() if key in ("k_smooth", "v_smooth")
                      else v) for key, v in kw.items()}
        got = paged_pool_attention(q[:, :, sq].contiguous(), kp[:, :, sk].contiguous(),
                                   vp[:, :, sk].contiguous(), *rest, **kw_r)
        ok &= bool(torch.equal(got, full[:, :, sq]))
    return ok


def _shard_bits(gen) -> dict:
    """Each kernel on a model rank's shard against the same part of its full
    launch, at llama2-7b's shapes, bf16 activations, quantized transform:
    B1 / B2 (`clustered_linear`) and B3 / B4 (`clustered_linear_multi`) at 8
    and 256 rows on every column shard at 2 and 4 ranks; B5 at T 1 and 32
    over bf16 and int8 pools on every kv-head shard at 2 and 4 ranks. All
    must be torch.equal. Then two ops the mesh step keeps whole, informative:
    the bf16 head at half the rows and half the columns."""
    dev = gen.device
    cases = []
    with torch.no_grad():
        for m in (8, 256):
            for k, n in LLAMA_KN:
                for parts in (2, 4):
                    cases.append(dict(kernel="B1" if m < 128 else "B2", m=m, k=k, n=n,
                                      ranks=parts, equal=_columns_equal(gen, m, k, n, parts)))
            for group, (k, widths) in list(MULTI_GROUPS.items())[:2]:
                for parts in (2, 4):
                    cases.append(dict(kernel="B3" if m < 128 else "B4", group=group, m=m,
                                      ranks=parts,
                                      equal=_multi_columns_equal(gen, m, k, widths, parts)))
        for t in (1, 32):
            for pool in ("bf16", "int8"):
                for parts in (2, 4):
                    cases.append(dict(kernel="B5", t=t, pool=pool, heads=32, ranks=parts,
                                      equal=_heads_equal(gen, t, 32, 32, pool, 128, parts)))
        # the head, kept whole on every rank: its bits at half the rows / columns
        x = torch.randn((8, 4096), generator=gen, device=dev).to(torch.bfloat16)
        head = (torch.randn((4096, 32768), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        full = x @ head
        head_bits = dict(half_rows_same=bool(torch.equal(x[:4] @ head, full[:4])),
                         half_columns_same=bool(torch.equal(
                             x @ head[:, :16384].contiguous(), full[:, :16384])))
    return dict(cases=cases, head_kept_whole=head_bits)


def phase_serve_mesh(seed: int, params) -> dict:
    """Serving on a (data, model) mesh of one card (`[cuda:0] x n`: every
    rank's shard, gather and step runs for real; traffic between ranks is a
    copy on the card). On the `serve` weights (llama2-7b, 32 layers, LCD
    4-bit, quantized transform): B1-B5 on a rank's shard torch.equal to that
    part of the full launch (`_shard_bits`); one decode step's logits and
    the pool on (1, 2) and (2, 1) torch.equal to 1 x 1
    (`_mesh_logits_check`); the `serve` drive (12 requests, 24 new tokens) at
    MESH_DRIVE_LAYERS on 1 x 1, then on (1, 2) and (2, 1) through `_serve`:
    1 x 1's tokens, engine = solo, launch counts (every rank launches), every
    replay equal to its eager body, step times beside 1 x 1's; the int8 pool at 4 layers on
    (2, 2) with its own 1 x 1 engine's tokens, every replay equal to its
    eager body; `choose_layout`'s report over [cuda:0] x 4. Returns the
    mesh drives' launches."""
    from repro_torch.distributed.layout import choose_layout
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import EngineConfig, ServingEngine, calibrate_kv_smooth
    from repro_torch.models.config import get_config
    from repro_torch.models.registry import get_model
    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    bits = _shard_bits(gen)
    model = get_model(get_config("llama2-7b"))
    fails = [c for c in bits["cases"] if not c["equal"]]
    one = ServingEngine(model, params, EngineConfig(**SERVE_ECFG), device="cuda")
    want = _lockstep_logits(one, seed)
    del one
    logits = {f"{d}x{m}": _mesh_logits_check(model, params, seed, _mesh_of((d, m)), want)
              for d, m in MESH_SHAPES}
    fails += [(k, v) for k, v in logits.items() if not (v["logits_equal"] and v["caches_equal"])]
    # the serve drive at MESH_DRIVE_LAYERS on 1 x 1, then on each mesh with its tokens
    p4 = _first_layers(params, MESH_DRIVE_LAYERS)
    counts, rows, step_ms = {}, {"1x1": {}}, {}
    _, one_tokens = _serve("serve_mesh_1x1", "llama2-7b", seed, MESH_DRIVE_LAYERS, 12, 24, None,
                           solo_ids=(), params=p4, step_times=True, report=rows["1x1"])
    step_ms["1x1"] = rows["1x1"]["step_ms_8_slots_busy"]
    for d, m in MESH_SHAPES:
        key = f"{d}x{m}"
        rows[key] = {}
        c, _ = _serve(f"serve_mesh_{key}", "llama2-7b", seed, MESH_DRIVE_LAYERS, 12, 24, None,
                      solo_ids=(0, 11), params=p4, want_tokens=one_tokens,
                      want_name=f"1x1_at_{MESH_DRIVE_LAYERS}_layers", mesh=_mesh_of((d, m)),
                      step_times=True, report=rows[key])
        step_ms[key] = rows[key]["step_ms_8_slots_busy"]
        for n, v in c.items():
            counts[n] = counts.get(n, 0) + v
    # the int8 pool on (2, 2) at 4 layers, against its own 1 x 1 engine
    m4 = get_model(dataclasses.replace(get_config("llama2-7b"), n_layers=4))
    smooth = calibrate_kv_smooth(m4, p4, seed=seed)
    ecfg8 = EngineConfig(kv_dtype="int8", **SERVE_ECFG)
    prompts = _serve_prompts(m4.cfg.vocab, seed + 3, 8)
    int8 = {}
    for key, mesh in (("1x1", None), ("2x2", _mesh_of((2, 2)))):
        e = ServingEngine(m4, p4, ecfg8, mesh=mesh, device="cuda", kv_smooth=smooth)
        torch.cuda.synchronize()
        reset_launch_counts()
        reqs = _drive(e, prompts, 24)
        torch.cuda.synchronize()
        int8[key] = [list(r.out_tokens) for r in reqs]
        if mesh is not None:
            for n, v in launch_counts().items():
                counts[n] = counts.get(n, 0) + v
            _graph_check("serve_mesh_int8_2x2", e, seed)
        del e
    int8_same = int8["2x2"] == int8["1x1"]
    if not int8_same:
        fails.append("int8 2x2 tokens differ from its 1x1 engine's")
    _, report = choose_layout(model, params, EngineConfig(**SERVE_ECFG),
                              devices=[torch.device("cuda", 0)] * 4)
    decode = {k: v["decode_width_1"] for k, v in step_ms.items()}
    emit("serve_mesh", arch="llama2-7b", layers=32, drive_layers=MESH_DRIVE_LAYERS,
         shard_bits=bits,
         decode_step_logits=logits, int8_2x2_4_layers_tokens_equal_1x1=int8_same,
         step_ms_8_slots_busy=step_ms,
         decode_wall_ms_per_step={k: v["wall_ms_per_step"] for k, v in decode.items()},
         decode_device_ms_per_replay={k: v["device_ms_per_replay"] for k, v in decode.items()},
         launches=counts, layout_report_cuda0_x4=report)
    if fails:
        raise SystemExit(f"serve_mesh: {fails}")
    missing = [n for n in MESH_PATH if not counts.get(n)]
    if missing:
        raise SystemExit(f"serve_mesh: {missing} never launched: {counts}")
    return counts


# ---------------------------------------------------------------------------
# serving on a process mesh: one process per (data, model) rank
# ---------------------------------------------------------------------------

# `serve`'s llama2-7b weights cut to serve_mesh's int8 depth; the two meshes
# run as two processes on cuda:0 over gloo, one spawn, the second mesh made
# over the same processes
PROCESS_LAYERS = 4
PROCESS_SHAPES = ((1, 2), (2, 1))
PROCESS_BACKEND = "gloo"
PROCESS_TIMEOUT_S = 420
PROCESS_NEW_TOKENS = 16          # the lockstep prompts' new tokens: room for the timed steps
PROCESS_DECODE_STEPS = 8
# the prefix mix on (2, 1): a 64-token system prompt (4 blocks of 16) that a
# data-rank-0 slot writes and a data-rank-1 slot matches
PROCESS_SHARED_LEN = 64


def _digest(x) -> str:
    """SHA-256 (hex) of a tensor's, or a tree's tensors', dtypes, shapes and
    bytes (`distributed/collectives.py tree_digest`): equal where the
    tensors are torch.equal (finite values)."""
    from repro_torch.distributed.collectives import tree_digest
    return tree_digest(x).hex()


def _process_weights(seed):
    """(model, params on the CPU): `serve`'s weights (`_served_params`, 32
    layers on the card, from `seed`) cut to their first PROCESS_LAYERS
    layers."""
    from repro_torch.models.config import get_config
    from repro_torch.models.registry import get_model
    _, full = _served_params("llama2-7b", seed, 32)
    params = to_device(_first_layers(full, PROCESS_LAYERS), "cpu")
    del full
    torch.cuda.empty_cache()
    model = get_model(dataclasses.replace(get_config("llama2-7b"), n_layers=PROCESS_LAYERS))
    return model, params


def _process_prompts(vocab, seed):
    """(serve_mesh's lockstep prompts: 8 of 40-120 tokens; `serve`'s: 12 of
    40-200; the prefix mix: A and B open with one shared prompt, C1-C3 not)."""
    rng = np.random.default_rng(seed + 29)
    shared = rng.integers(0, vocab, PROCESS_SHARED_LEN).astype(np.int32)
    prefix = [np.concatenate([shared, rng.integers(0, vocab, n).astype(np.int32)])
              for n in (20, 25)] + [rng.integers(0, vocab, 30).astype(np.int32)
                                    for _ in range(3)]
    return dict(lockstep=_lockstep_prompts(vocab, seed), serve=_serve_prompts(vocab, seed, 12),
                prefix=prefix)


class _StepDigests:
    """The engine's model with every serving step's logits digested."""

    def __init__(self, model):
        self.model, self.digests = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def serving_step(self, *a):
        out = self.model.serving_step(*a)
        self.digests.append(_digest(out[0]))
        return out


def _pool_digests(engine):
    """Per pool leaf, the digest of each part this process holds (every
    model rank's part on a one-process mesh)."""
    from repro_torch.distributed.sharding import Sharded
    view = engine.caches["paged"].views[0]
    return {name: [_digest(p) for p in leaf.parts] if isinstance(leaf, Sharded)
            else [_digest(leaf)] for name, leaf in view.items()}


def _process_engine(model, params, mesh, kv_dtype=None, smooth=None, prefix=False):
    """(engine, device bytes its construction left allocated): on a
    one-process mesh the steps run the eager body, as a process mesh's do."""
    from repro_torch.launch.engine import EngineConfig, ServingEngine
    from repro_torch.launch.mesh import is_process_mesh
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = ServingEngine(model, params, EngineConfig(kv_dtype=kv_dtype, prefix_cache=prefix,
                                                       **SERVE_ECFG),
                           mesh=mesh, device="cuda", kv_smooth=smooth)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    if not is_process_mesh(mesh):
        engine._model_step = engine._eager_step
    engine.model = _StepDigests(model)
    return engine, held


def _process_lockstep(engine, prompts):
    """The lockstep prompts submitted at once, stepped until every slot
    decodes; then PROCESS_DECODE_STEPS decode steps timed on the host clock
    (synchronised; logits not digested) with this process's collectives
    counted; then run to the end."""
    from repro_torch.distributed import collectives
    reqs = [_submit(engine, p, PROCESS_NEW_TOKENS) for p in prompts]
    _step_until_decoding(engine)
    wrapped, engine.model = engine.model, engine.model.model
    ran = engine.traces.get(1, 0)
    collectives.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROCESS_DECODE_STEPS):
        engine.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / PROCESS_DECODE_STEPS
    counts = collectives.collective_counts()
    engine.model = wrapped
    if engine.traces.get(1, 0) - ran != PROCESS_DECODE_STEPS or any(
            r is None or r.prefilling for r in engine.slots):
        raise SystemExit("serve_processes: the timed steps were not all of width 1 with "
                         "every slot decoding")
    engine.run()
    per_step = {name: {k: v / PROCESS_DECODE_STEPS for k, v in c.items()}
                for name, c in counts.items()}
    return [list(r.out_tokens) for r in reqs], dict(
        eager_wall_ms_per_decode_step=round(wall, 3), collectives_per_decode_step=per_step)


def _process_prefix(engine, prompts):
    """The prefix mix: A and C1-C3 admitted into slots 0-3 (data rank 0 on
    (2, 1)); once A's prefill is done its system-prompt blocks are cached,
    and B, opening with the same prompt, takes slot 4 (data rank 1)."""
    a, b, *cs = prompts
    reqs = [_submit(engine, p, PROCESS_NEW_TOKENS) for p in [a] + cs]
    while reqs[0].prefilling or not reqs[0].out_tokens:
        engine.step()
    rb = _submit(engine, b, PROCESS_NEW_TOKENS)
    engine.step()
    slot_b = rb.slot
    engine.run()
    return dict(tokens=[list(r.out_tokens) for r in [reqs[0], rb] + reqs[1:]], slot_b=slot_b,
                cached_tokens=engine.cache_stats["cached_tokens"])


def _process_mesh_drives(model, params, mesh, smooth, prompts) -> dict:
    """The drives of one mesh, on a one-process mesh (the yardstick) or as
    one process of a process mesh: the lockstep and serve drives (tokens,
    every step's logits digested, the pool's digests after each, launches
    per drive, the bytes the engine holds), then with a data axis of 2 the
    int8 pool (lockstep prompts) and the prefix mix, cache on (a process
    mesh) or off (the yardstick)."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import _tree_bytes
    from repro_torch.launch.mesh import is_process_mesh
    out, launches = {}, {}

    def launched(drive):
        for n, c in launch_counts().items():
            if c:
                launches.setdefault(drive, {})[n] = c

    engine, held = _process_engine(model, params, mesh)
    out["bytes"] = dict(memory_allocated_after_placement=held,
                        params=_tree_bytes(engine.params),
                        pool=_tree_bytes(engine.caches["paged"]))
    out["eager_reason"] = engine.eager_reason
    if not is_process_mesh(mesh):
        out["bytes"]["per_model_rank"] = [
            dict(params=_tree_bytes(engine.params.rank_tree(m)),
                 pool=sum(_tree_bytes(leaf.parts[m])
                          for leaf in engine.caches["paged"].views[0].values()))
            for m in range(mesh.shape["model"])]
    for drive in ("lockstep", "serve"):
        torch.cuda.synchronize()
        reset_launch_counts()
        n0 = len(engine.model.digests)
        if drive == "lockstep":
            tokens, row = _process_lockstep(engine, prompts["lockstep"])
        else:
            reqs = _drive(engine, prompts["serve"], 24)
            tokens, row = [list(r.out_tokens) for r in reqs], {}
        torch.cuda.synchronize()
        launched(drive)
        out[drive] = dict(tokens=tokens, logits=engine.model.digests[n0:],
                          pool=_pool_digests(engine), **row)
    del engine
    if mesh.shape["data"] > 1:
        reset_launch_counts()
        engine, _ = _process_engine(model, params, mesh, kv_dtype="int8", smooth=smooth)
        tokens, _ = _process_lockstep(engine, prompts["lockstep"])
        launched("int8")
        out["int8"] = dict(tokens=tokens, logits=engine.model.digests)
        del engine
        reset_launch_counts()
        engine, _ = _process_engine(model, params, mesh, prefix=is_process_mesh(mesh))
        out["prefix"] = _process_prefix(engine, prompts["prefix"])
        launched("prefix")
        del engine
    out["launches"] = launches
    torch.cuda.empty_cache()
    return out


def _processes_child(mesh, seed, smooth, weights_digest) -> dict:
    """One process of the process meshes: `serve`'s weights made again from
    `seed` and held to the parent's digest, then `_process_mesh_drives` on
    each of PROCESS_SHAPES (the first is `mesh`, the second made over the
    same processes)."""
    from repro_torch.distributed.collectives import staged
    from repro_torch.launch.mesh import init_process_mesh
    model, params = _process_weights(seed)
    if _digest(params) != weights_digest:
        raise SystemExit(f"serve_processes: rank {mesh.rank}'s weights differ from the "
                         f"parent's")
    prompts = _process_prompts(model.cfg.vocab, seed)
    out = {}
    for shape in PROCESS_SHAPES:
        m = mesh if tuple(mesh.devices.shape) == shape else init_process_mesh(
            shape, backend=mesh.backend, device=mesh.device)
        row = _process_mesh_drives(model, params, m, smooth, prompts)
        row.update(rank=m.rank, coord=m.coord, staged_through_host=staged(
            m.group("world"), torch.empty(1, device=m.device)))
        out["x".join(map(str, shape))] = row
    return out


def phase_serve_processes(seed: int, params, smi: str) -> dict:
    """Serving on a process mesh: PROCESS_SHAPES as two processes on cuda:0
    over gloo (one card; NCCL refuses two ranks on one device), spawned once
    after the build, so that they load the parent's library. `serve`'s
    llama2-7b at full width cut to PROCESS_LAYERS layers (LCD 4-bit,
    quantized transform); the yardstick, the one-process mesh engine of the
    same shape on [cuda:0] x 2 and the 1 x 1 engine, eager, in this process.
    Holds (a) every process's tokens and every step's logits (digests)
    equal to the one-process mesh's, whose tokens equal 1 x 1's; (b) each
    pool replica equal to the one-process pool's part of its model rank
    after each drive; (c) every process launching every kernel of
    MESH_PATH; (d) on (2, 1) a cached system prompt, written by a
    data-rank-0 slot, matched into a data-rank-1 slot with the cache-off
    tokens; (e) the int8 pool on (2, 1) with its one-process engine's tokens
    and logits; and each process's parameter bytes equal to its model
    rank's on the one-process mesh. Reports the bytes each process holds,
    the collectives and eager ms per decode step. Returns the processes'
    launches."""
    from repro_torch.launch.engine import _tree_bytes, calibrate_kv_smooth
    from repro_torch.launch.mesh import make_mesh, run_on_processes
    from repro_torch.models.config import get_config
    from repro_torch.models.registry import get_model
    model = get_model(dataclasses.replace(get_config("llama2-7b"), n_layers=PROCESS_LAYERS))
    params = to_device(_first_layers(params, PROCESS_LAYERS), "cpu")
    prompts = _process_prompts(model.cfg.vocab, seed)
    smooth = calibrate_kv_smooth(model, to_device(params, "cuda"), seed=seed)
    one = {}
    for shape in PROCESS_SHAPES:
        mesh = make_mesh(shape, ("data", "model"), [torch.device("cuda", 0)] * 2)
        one["x".join(map(str, shape))] = _process_mesh_drives(model, params, mesh, smooth,
                                                              prompts)
    one_by_one, _ = _process_engine(model, to_device(params, "cuda"), None)
    one_tokens = {drive: _process_lockstep(one_by_one, prompts["lockstep"])[0]
                  if drive == "lockstep" else
                  [list(r.out_tokens) for r in _drive(one_by_one, prompts["serve"], 24)]
                  for drive in ("lockstep", "serve")}
    del one_by_one
    t0 = time.perf_counter()
    results = run_on_processes(_processes_child, PROCESS_SHAPES[0], backend=PROCESS_BACKEND,
                               devices=[torch.device("cuda", 0)] * 2,
                               timeout_s=PROCESS_TIMEOUT_S,
                               args=(seed, smooth, _digest(params)))
    spawn_s = time.perf_counter() - t0
    fails, rows, counts = [], {}, {}
    for key, yard in one.items():
        for drive in ("lockstep", "serve"):
            if yard[drive]["tokens"] != one_tokens[drive]:
                fails.append(f"{key} one-process {drive} tokens differ from 1 x 1's")
        procs = []
        for res in results:
            r = res[key]
            m = r["coord"]["model"]
            check = {f"{drive}_{what}": r[drive][what] == yard[drive][what]
                     for drive in ("lockstep", "serve") for what in ("tokens", "logits")}
            for drive in ("lockstep", "serve"):
                check[f"{drive}_pool_replica"] = all(
                    r[drive]["pool"][name] == [parts[m]]
                    for name, parts in yard[drive]["pool"].items())
            check["param_bytes_of_its_model_rank"] = (
                r["bytes"]["params"] == yard["bytes"]["per_model_rank"][m]["params"])
            missing = [n for n in MESH_PATH
                       if not sum(c.get(n, 0) for c in r["launches"].values())]
            check["every_mesh_path_kernel_launched"] = not missing
            if "int8" in r:
                check["int8_tokens"] = r["int8"]["tokens"] == yard["int8"]["tokens"]
                check["int8_logits"] = r["int8"]["logits"] == yard["int8"]["logits"]
                p = r["prefix"]
                check["prefix_matched_into_data_rank_1"] = (
                    p["slot_b"] >= SERVE_ECFG["num_slots"] // 2
                    and p["cached_tokens"] >= PROCESS_SHARED_LEN)
                check["prefix_tokens_equal_cache_off"] = p["tokens"] == yard["prefix"]["tokens"]
            fails += [f"{key} rank {r['rank']}: {k}" for k, ok in check.items() if not ok]
            for c in r["launches"].values():
                for n, v in c.items():
                    counts[n] = counts.get(n, 0) + v
            procs.append(dict(
                rank=r["rank"], coord=r["coord"], checks=check, bytes=r["bytes"],
                eager_reason=r["eager_reason"], staged_through_host=r["staged_through_host"],
                launches=r["launches"],
                eager_wall_ms_per_decode_step=r["lockstep"]["eager_wall_ms_per_decode_step"],
                collectives_per_decode_step=r["lockstep"]["collectives_per_decode_step"],
                prefix={k: v for k, v in r.get("prefix", {}).items() if k != "tokens"}))
        rows[key] = dict(processes=procs, one_process=dict(
            bytes=yard["bytes"], launches=yard["launches"],
            eager_wall_ms_per_decode_step=yard["lockstep"]["eager_wall_ms_per_decode_step"],
            collectives_per_decode_step=yard["lockstep"]["collectives_per_decode_step"]))
    emit("serve_processes", arch="llama2-7b", layers=PROCESS_LAYERS, card=smi,
         backend=PROCESS_BACKEND, processes=2, whole_model_param_bytes=_tree_bytes(params),
         spawn_and_drives_s=round(spawn_s, 1), meshes=rows)
    if fails:
        raise SystemExit(f"serve_processes: {fails}")
    return counts


# ---------------------------------------------------------------------------
# every other family on a (data, model) mesh of one card
# ---------------------------------------------------------------------------

# full width, LCD 4-bit, quantized transform; cut to these depths (zamba2's 2
# layers run one shared-attention site after them, whisper's 4 are 4 + 4;
# rwkv6 and gla 4 -> 2 for the 820 s mark when every family came to train on a
# mesh, zamba2 6 -> 2 for the dry run)
MESH_FAMILY_DEPTHS = (("phi3.5-moe-42b-a6.6b", 2), ("llama4-scout-17b-a16e", 2),
                      ("rwkv6-1.6b", 2), ("gla-1.3b", 2), ("zamba2-1.2b", 2),
                      ("whisper-large-v3", 4))
# the drive of every arch and mesh: 8 requests of 16-48 prompt tokens, 16 new,
# submitted at once (`_lockstep_drive`)
MESH_FAMILY_DRIVE = dict(n=8, lens=(16, 49), new_tokens=16)
# B1 / B3 at the new families' projections (2-way column shards, M = 8)
MESH_FAMILY_SOLO = {"rwkv6 r/k/v/g/o, gla q/k/v/o": (2048, 2048),
                    "rwkv6 cm.wk": (2048, 7168), "rwkv6 cm.wv": (7168, 2048),
                    "gla w_up": (2048, 5632), "gla w_down": (5632, 2048),
                    "zamba2 w_out": (4096, 2048), "whisper q/k/v": (1280, 2048),
                    "whisper wo": (2048, 1280), "whisper w_up": (1280, 5120),
                    "whisper w_down": (5120, 1280), "llama4-scout wo": (6144, 5120)}
MESH_FAMILY_MULTI = {"zamba2 shared QKV": (2048, (2048, 2048, 2048)),
                     "zamba2 shared gate+up": (2048, (8192, 8192)),
                     "phi3.5-moe QKV": (4096, (4096, 1024, 1024)),
                     "llama4-scout QKV": (5120, (6144, 1024, 1024))}


def _family_shard_bits(gen) -> dict:
    """The ops a rank runs on its part of the new families' cuts, against
    the same part of the whole, all torch.equal: B1 (M 8) on 2-way column
    shards at their projections, B3 on 2-way shards of their QKV and
    gate+up groups, B5 on 2-way kv-head shards at zamba2's sites (D 64,
    H = KV = 32) and phi3.5-moe's attention (D 128, 32 over 8), an MoE
    layer's experts' SwiGLU (`layers._expert_swiglu`, bf16) at E/2 against
    its slice at E, and whisper's ragged attention (bf16, 32 padded heads,
    self over 512 keys and cross over 1500) at H/2 against its slice at H."""
    from repro_torch.models import layers
    dev = gen.device
    cases = []
    with torch.no_grad():
        for name, (k, n) in MESH_FAMILY_SOLO.items():
            cases.append(dict(kernel="B1", shape=name, m=8, k=k, n=n, ranks=2,
                              equal=_columns_equal(gen, 8, k, n, 2)))
        for name, (k, widths) in MESH_FAMILY_MULTI.items():
            cases.append(dict(kernel="B3", shape=name, m=8, k=k, widths=list(widths), ranks=2,
                              equal=_multi_columns_equal(gen, 8, k, widths, 2)))
        cases.append(dict(kernel="B5", shape="zamba2 sites", t=1, heads=32, kv=32, d=64,
                          ranks=2, equal=_heads_equal(gen, 1, 32, 32, "bf16", 64, 2)))
        cases.append(dict(kernel="B5", shape="phi3.5-moe attention", t=1, heads=32, kv=8,
                          d=128, ranks=2, equal=_heads_equal(gen, 1, 32, 8, "bf16", 128, 2)))
        # phi3.5-moe's experts at a decode step's capacity (8 tokens, top-2: C = 4)
        e, d, f = 16, 4096, 6400
        xe = torch.randn((e, 1, 4, d), generator=gen, device=dev).to(torch.bfloat16)
        ws = [(torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
              for shape in ((e, d, f), (e, d, f), (e, f, d))]
        full = layers._expert_swiglu(xe, *ws)
        half = [layers._expert_swiglu(xe[r * 8:(r + 1) * 8], *(w[r * 8:(r + 1) * 8] for w in ws))
                for r in range(2)]
        cases.append(dict(op="moe experts' SwiGLU", experts=e, ranks=2,
                          equal=all(torch.equal(h, full[r * 8:(r + 1) * 8])
                                    for r, h in enumerate(half))))
        del ws
        # whisper's attention of 8 slots at width 1 over its self and cross K/V
        s, h, hd = 8, 32, 64
        for what, keys, causal in (("self", 512, True), ("cross", 1500, False)):
            q = torch.randn((s, 1, h, hd), generator=gen, device=dev).to(torch.bfloat16)
            kv = [torch.randn((s, keys, h, hd), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2)]
            pos = torch.tensor([[200], [37], [0], [95], [16], [0], [130], [63]], device=dev)
            k_len = (pos[:, 0] + 1) if causal else None
            k_pos = torch.arange(keys, device=dev)
            full = layers.ragged_attention(q, *kv, pos, k_pos, causal=causal,
                                           scale=1 / math.sqrt(hd), k_len=k_len)
            ok = True
            for r in range(2):
                hs = slice(r * h // 2, (r + 1) * h // 2)
                got = layers.ragged_attention(q[:, :, hs].contiguous(),
                                              *(a[:, :, hs].contiguous() for a in kv), pos,
                                              k_pos, causal=causal, scale=1 / math.sqrt(hd),
                                              k_len=k_len)
                ok &= bool(torch.equal(got, full[:, :, hs]))
            cases.append(dict(op=f"whisper ragged attention ({what})", heads=h, keys=keys,
                              ranks=2, equal=ok))
    return dict(cases=cases)


def _family_prompts(cfg, seed):
    rng = np.random.default_rng(seed + 5)
    lo, hi = MESH_FAMILY_DRIVE["lens"]
    return [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(MESH_FAMILY_DRIVE["n"])]


def _mesh_family_arch(arch, layers, seed, counts, graph_mesh) -> dict:
    """One arch of `serve_mesh_family`: the drive (`_lockstep_drive` of
    `_family_prompts`, its decode steps timed) of its 1 x 1 engine, then of
    an engine on each of MESH_SHAPES, whose next decode step's logits, paged
    pool and slot state and whose tokens must equal 1 x 1's; on
    `graph_mesh` every replay must also equal its eager body (`_graph_check`,
    a preemption inside); rwkv6 on (2, 1) also preempted = unpreempted
    (`_preempt_check`). Adds the mesh drives' launches to `counts`; returns
    the arch's line."""
    from repro_torch.distributed.layout import choose_layout
    from repro_torch.launch.engine import EngineConfig, ServingEngine
    t0 = time.perf_counter()
    model, params = _served_params(arch, seed, layers)
    ecfg = EngineConfig(**SERVE_ECFG)
    prompts = _family_prompts(model.cfg, seed)
    new = MESH_FAMILY_DRIVE["new_tokens"]
    one = ServingEngine(model, params, ecfg, device="cuda")
    (want_logits, want_caches, want_seen, tokens), _, one_ms = _lockstep_drive(
        one, prompts, new, timed=True)
    decode = {"1x1": one_ms}
    del one
    fails, rows = [], {}
    for shape in MESH_SHAPES:
        key = f"{shape[0]}x{shape[1]}"
        engine = ServingEngine(model, params, ecfg, mesh=_mesh_of(shape), device="cuda")
        (got, caches, seen, got_tokens), launched, decode[key] = _lockstep_drive(
            engine, prompts, new, timed=True)
        for n, c in launched.items():
            counts[n] = counts.get(n, 0) + c
        row = dict(logits_equal=bool(torch.equal(got, want_logits)) and seen == want_seen,
                   max_abs_diff=float((got.float() - want_logits.float()).abs().max()),
                   caches_equal=all(torch.equal(want_caches[k], caches[k]) for k in want_caches),
                   same_tokens_as_1x1=got_tokens == tokens, **seen, launches=launched)
        if arch == "rwkv6-1.6b" and shape == (2, 1):
            row["preemption"] = _preempt_check(engine, prompts, tokens, new)
            if not row["preemption"]["ok"]:
                fails.append(f"{key}: preemption {row['preemption']}")
        if shape == graph_mesh:
            _graph_check(f"serve_mesh_family_{key}", engine, seed, prompt_lens=(20, 9, 36, 14))
        if not (row["logits_equal"] and row["caches_equal"] and row["same_tokens_as_1x1"]
                and seen["slots_decoding"] == ecfg.num_slots):
            fails.append(f"{key}: {row}")
        rows[key] = row
        del engine
    _, report = choose_layout(model, params, ecfg, devices=[torch.device("cuda", 0)] * 4)
    del params
    torch.cuda.empty_cache()
    line = dict(arch=arch, layers=layers, meshes=rows, graph_checked_on=list(graph_mesh),
                decode_ms_8_slots_decoding=decode, layout_report_cuda0_x4=report,
                seconds=round(time.perf_counter() - t0, 1))
    emit("serve_mesh_family_arch", **line)
    if fails:
        raise SystemExit(f"serve_mesh_family: {arch}: {fails}")
    return line


def phase_serve_mesh_family(seed: int) -> dict:
    """Every family but the dense one on (data, model) meshes of one card
    (`[cuda:0] x 2` at (1, 2) and (2, 1)): the MoE archs (their experts cut
    over the model axis, a step's rows routed once), rwkv6, gla, zamba2 and
    whisper (their slot state cut by heads) at full width (MESH_FAMILY_DEPTHS),
    LCD 4-bit, quantized transform: the ops on a rank's parts torch.equal to
    the whole (`_family_shard_bits`), then per arch `_mesh_family_arch`.
    Returns the mesh drives' launches."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 43)
    bits = _family_shard_bits(gen)
    emit("serve_mesh_family_shard_bits", **bits)
    bad = [c for c in bits["cases"] if not c["equal"]]
    if bad:
        raise SystemExit(f"serve_mesh_family: a rank's part differs from the whole: {bad}")
    counts = {}
    for i, (arch, layers) in enumerate(MESH_FAMILY_DEPTHS):
        # the graph check on one mesh an arch, the two meshes in turn
        _mesh_family_arch(arch, layers, seed, counts, MESH_SHAPES[i % len(MESH_SHAPES)])
    missing = [n for n in MESH_PATH if not counts.get(n)]
    if missing:
        raise SystemExit(f"serve_mesh_family: {missing} never launched: {counts}")
    return counts


# the rest of the transformer family at full width: paligemma-3b at full
# depth, gemma2-27b, starcoder2-15b and stablelm-12b cut to 4 layers (gemma2's
# local / global pair twice; the run's time has the mesh phases to hold)
FAMILY_DEPTHS = (("gemma2-27b", 4), ("paligemma-3b", 18), ("starcoder2-15b", 4),
                 ("stablelm-12b", 4))


def phase_serve_family(seed: int) -> dict:
    """Each arch of FAMILY_DEPTHS served like `serve`: LCD 4-bit weights from
    the seed with the quantized transform, the `serve` engine's geometry and
    request mix, launch counts per arch (the gelu MLP: one multi launch a
    layer), engine = solo tokens, every replay = its eager body; gemma2-27b
    also its step times with 8 slots busy. Then on the first 4 layers of the
    same weights fused = unfused tokens, and for starcoder2-15b (layernorm)
    a drive over the int8 pool. Returns the full-depth drives' launches
    summed over the archs."""
    total = {}
    for arch, layers in FAMILY_DEPTHS:
        t0 = time.perf_counter()
        _, params = _served_params(arch, seed, layers)
        counts, tokens = _serve("serve_family", arch, seed, layers, 12, 24, None,
                                solo_ids=(0, 11), params=params,
                                step_times=arch == "gemma2-27b")
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        four = params if layers == 4 else _first_layers(params, 4)
        if layers != 4:
            _, tokens = _serve("serve_family_4_layers", arch, seed, 4, 12, 24, None,
                               solo_ids=(), params=four)
        _serve("serve_family_unfused", arch, seed, 4, 12, 24, None, solo_ids=(), fused=False,
               params=four, want_tokens=tokens)
        if arch == "starcoder2-15b":
            _serve("serve_family_int8", arch, seed, 4, 4, 24, "int8", solo_ids=(1, 3),
                   params=four)
        del params, four
        # the peak since the phase began: gemma2-27b's own, as it runs first
        emit("serve_family_arch", arch=arch, layers=layers,
             seconds=round(time.perf_counter() - t0, 1),
             peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    return total


def _static_graph_check(model, params, batch, prompt_len, seed, gen=8) -> dict:
    """The static path's decode graph against its eager body: after one
    prefill, `decode` (a warm-up step, then gen - 1 replays of the captured
    step, each with the next token and position in the same buffers) on the
    cache and the eager steps (`model.decode` and the greedy pick) on a
    clone of it; the tokens and every cache tensor, `pos` included, must be
    torch.equal. Fails the run on a miss."""
    from repro_torch.launch.engine import build_decode_fns
    vocab = model.cfg.vocab
    prompt = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, vocab, (batch, prompt_len)).astype(np.int32)).cuda()
    prefill, decode, _ = build_decode_fns(model, model.cfg, gen)
    tok, cache = prefill(params, model.init_cache(batch, prompt_len + gen, device="cuda"), prompt)
    clone = {k: v.clone() for k, v in cache.items()}
    toks, cache = decode(params, cache, tok)
    want = []
    with torch.no_grad():
        for _ in range(gen):
            logits, clone = model.decode(params, clone, {"tokens": tok, "pos": clone["pos"]})
            want.append(tok[:, 0])
            tok = torch.argmax(logits[:, :vocab], dim=-1)[:, None].to(torch.int32)
    same = torch.equal(toks, torch.stack(want, dim=1))
    bad = [k for k in cache if not torch.equal(cache[k], clone[k])]
    row = dict(engine="serve_static", ok=same and not bad, steps_compared=gen,
               replays=gen - 1, same_tokens=same, cache_tensors_differ=bad,
               pos=int(cache["pos"]))
    emit("graph", **row)
    if not row["ok"]:
        raise SystemExit(f"graph: the static decode's replays differ from its eager body: {row}")
    return row


def _decode_ms_per_step(model, params, batch, prompt_len, seed) -> float:
    """Device milliseconds of one static decode step (`model.decode` over
    the contiguous cache and the greedy pick, its position and token in
    device buffers) captured and replayed by `time_ms`, after a prefill."""
    from repro_torch.launch.engine import build_decode_fns
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab, (batch, prompt_len)).astype(np.int32)).cuda()
    iters, warmup = 8, 2
    prefill, _, _ = build_decode_fns(model, model.cfg, 1)
    # time_ms runs the step warmup + 4 x iters times: room for every position
    cache = model.init_cache(batch, prompt_len + warmup + 4 * iters, device="cuda")
    tok, cache = prefill(params, cache, prompt)

    @torch.no_grad()
    def step(_):
        logits, _ = model.decode(params, cache, {"tokens": tok, "pos": cache["pos"]})
        tok.copy_(torch.argmax(logits[:, :model.cfg.vocab], dim=-1)[:, None].to(torch.int32))

    return time_ms(step, iters, warmup)


def phase_serve_static(seed: int, params) -> None:
    """llama2-7b at full width and depth through the static-batch `serve()`:
    one prefill step at M = 4 x 64 (B4 and B2) and 16 decode steps at M = 4
    (B3 and B1), 4 LUT launches per layer per step, the decode one captured
    step replayed; the same steps again under
    torch.cuda.set_sync_debug_mode("error"); the decode graph's replays
    against its eager body (`graph`). Then the paper's decode comparison:
    dense bf16 llama2-7b at full width (random weights from the seed, plain
    `torch.matmul` projections) through the same `serve()`, and both
    models' device milliseconds per captured decode step, in turns. Last,
    the static step against the paged step on the same prompts: f32, float
    transform, 2 layers, full width."""
    import dataclasses

    from repro_torch.core.clustered_params import materialize_clustered
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import build_decode_fns, serve
    from repro_torch.models.config import get_config
    from repro_torch.models.registry import get_model

    batch, prompt_len, gen_tokens, n_layers = 4, 64, 16, 32
    torch.cuda.synchronize()
    reset_launch_counts()
    stats = {}
    gen, _ = serve("llama2-7b", use_reduced=False, lcd=True, batch=batch,
                   prompt_len=prompt_len, gen_tokens=gen_tokens, seed=seed, params=params,
                   stats=stats, device="cuda")
    counts = launch_counts()
    steps = 1 + gen_tokens
    expected = {"lut_matmul_fused_multi": 2 * n_layers, "lut_matmul_fused": 2 * n_layers,
                "lut_matmul_fused_multi_gemv": 2 * n_layers * gen_tokens,
                "lut_matmul_fused_gemv": 2 * n_layers * gen_tokens,
                "paged_pool_attention": 0, **NOT_SERVING}
    vocab = get_config("llama2-7b").vocab
    ok = (stats["traces"] == {"prefill": 1, "decode": 1} and counts == expected
          and gen.shape == (batch, gen_tokens) and bool(((gen >= 0) & (gen < vocab)).all()))

    # the same two computations with every host synchronisation an error
    model = get_model("llama2-7b")
    prefill, decode, _ = build_decode_fns(model, model.cfg, 2)
    cache = model.init_cache(batch, prompt_len + 2, device="cuda")
    prompt = torch.randint(0, vocab, (batch, prompt_len), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok, cache = prefill(params, cache, prompt)
        toks, cache = decode(params, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    del cache
    graph_row = _static_graph_check(model, params, batch, prompt_len, seed)

    # the paper's decode comparison: LCD 4-bit against dense bf16, same path;
    # the captured decode step's device time, read in turns
    dense_stats = {}
    dense_gen, dense = serve("llama2-7b", use_reduced=False, lcd=False, batch=batch,
                             prompt_len=prompt_len, gen_tokens=gen_tokens, seed=seed,
                             stats=dense_stats, device="cuda")
    step_ms = {"lcd": [], "dense": []}
    for name in ("lcd", "dense", "dense", "lcd"):
        step_ms[name].append(_decode_ms_per_step(model, params if name == "lcd" else dense,
                                                 batch, prompt_len, seed))
    del dense
    lcd_ms, dense_ms = (sum(step_ms[n]) / 2 for n in ("lcd", "dense"))
    dense_ok = (dense_stats["traces"] == {"prefill": 1, "decode": 1}
                and dense_gen.shape == (batch, gen_tokens)
                and bool(((dense_gen >= 0) & (dense_gen < vocab)).all()))

    # static vs paged: same prompts, same params, f32 with the float transform
    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=2, dtype="float32")
    model2 = get_model(cfg)
    p2 = materialize_clustered(model2, torch.Generator(device="cuda").manual_seed(seed + 1),
                               nbits=4, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, vocab, (batch, prompt_len)).astype(np.int32))
    bs, nbw = 16, (prompt_len + 2 + 15) // 16
    tables = torch.arange(batch * nbw, dtype=torch.int32).reshape(batch, nbw)
    caches = model2.init_seq_caches(num_blocks=batch * nbw, block_size=bs, num_slots=batch,
                                    max_seq=nbw * bs, kv_dtype="float", device="cuda")
    scache = model2.init_cache(batch, prompt_len + 2, device="cuda")
    lengths = torch.zeros(batch, dtype=torch.int32)
    feed, diffs = prompts, []
    for _ in range(3):                                   # the prompt, then 2 tokens
        n_new = torch.full((batch,), feed.shape[1], dtype=torch.int32)
        lp, caches = model2.serving_step(p2, caches, *[t.cuda() for t in (feed, lengths, n_new,
                                                                          tables)])
        ls, scache = model2.decode(p2, scache, {"tokens": feed.cuda(), "pos": scache["pos"]})
        diffs.append(float((lp[:, :vocab] - ls[:, :vocab]).abs().max()))
        lengths = lengths + n_new
        feed = torch.argmax(ls[:, :vocab], dim=-1)[:, None].to(torch.int32).cpu()
    torch.cuda.synchronize()
    parity_ok = max(diffs) <= 1e-3
    emit("serve_static", arch="llama2-7b", layers=n_layers, batch=batch,
         prompt_len=prompt_len, gen_tokens=gen_tokens, traces=stats["traces"],
         model_steps=steps, launches=counts, launches_expected=expected,
         prefill_s=round(stats["prefill_s"], 3), decode_s=round(stats["decode_s"], 3),
         tokens_per_s=round(stats["tokens_per_s"], 2), sync_free_steps=True,
         decode_graph_replays_equal_eager=graph_row["ok"],
         device_ms_per_decode_step=round(lcd_ms, 3),
         device_ms_per_decode_step_reads=[round(x, 3) for x in step_ms["lcd"]],
         dense_bf16=dict(tokens_per_s=round(dense_stats["tokens_per_s"], 2),
                         prefill_s=round(dense_stats["prefill_s"], 3),
                         decode_s=round(dense_stats["decode_s"], 3),
                         device_ms_per_decode_step=round(dense_ms, 3),
                         device_ms_per_decode_step_reads=[round(x, 3) for x in step_ms["dense"]],
                         traces=dense_stats["traces"]),
         lcd_vs_dense_tokens_per_s=round(stats["tokens_per_s"] / dense_stats["tokens_per_s"], 3),
         lcd_vs_dense_device_step_speed=round(dense_ms / lcd_ms, 3),
         static_vs_paged=dict(dtype="float32", layers=2, max_abs_logit_diff=diffs,
                              tol=1e-3))
    if not dense_ok:
        raise SystemExit(f"serve_static: the dense bf16 run's traces or tokens are wrong: "
                         f"{dense_stats['traces']}, {dense_gen.shape}")
    if not ok:
        raise SystemExit(f"serve_static: traces, launch counts or tokens are wrong: "
                         f"{stats['traces']}, {counts} vs {expected}")
    if not parity_ok:
        raise SystemExit(f"serve_static: static and paged logits differ: {diffs}")


@contextlib.contextmanager
def _eager_body(engine, eager):
    """With `eager`, the engine's steps inside run its eager body
    (`ServingEngine._eager_step`) in place of its graphs."""
    if eager:
        engine._model_step = engine._eager_step
    try:
        yield
    finally:
        engine.__dict__.pop("_model_step", None)


def _wall_ms_per_step(engine, n_steps, eager=False):
    """(host-clock ms per step, ms per step between CUDA events recorded
    before the first step and after the last) over `n_steps` steps, profiler
    off."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with _eager_body(engine, eager):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(n_steps):
            engine.step()
        end.record()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_steps, start.elapsed_time(end) / n_steps


def _profile_steps(engine, n_steps, eager=False):
    """Device rows under torch.profiler over `n_steps` engine steps, after
    one step it discards as its warm-up (`_profile_calls`)."""
    with _eager_body(engine, eager):
        return _profile_calls(engine.step, n_steps)


def _profile_calls(step, n_steps, host_ops=True):
    """Device rows under torch.profiler over `n_steps` calls of `step`, after
    one call it discards as its warm-up: (kernel, ms per step, calls per
    step), the longest first. `host_ops=False` records the device's
    activity alone (a train step's thousands of host ops cost seconds to
    read)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    rows = []

    def read(prof):
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue      # host-side ops repeat their kernels' device time
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = getattr(ev, "self_cuda_time_total", 0.0)
            if dev > 0 and not ev.key.startswith("ProfilerStep"):   # the step's own range
                rows.append((ev.key, dev / 1e3 / n_steps, ev.count / n_steps))

    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=n_steps, repeat=1),
                 on_trace_ready=read) as prof:
        for _ in range(n_steps + 1):
            step()
            prof.step()
    torch.cuda.synchronize()
    rows.sort(key=lambda r: -r[1])
    return rows


def _train_trace(step, s_per_step):
    """Where one train step's time goes: `step` (a train step whose result
    is dropped) under `_profile_calls` for one step, its device busy time
    beside `s_per_step` (the profiler-off steady step): the device's idle
    share, kernels per step, the longest kernels."""
    rows = _profile_calls(step, 1, host_ops=False)
    busy = sum(r[1] for r in rows)
    wall = s_per_step * 1e3
    return dict(device_busy_ms_per_step=round(busy, 3) if rows else "not measured",
                device_idle_share=round(1.0 - busy / wall, 3) if rows else "not measured",
                device_calls_per_step=round(sum(r[2] for r in rows), 1),
                top_kernels=[dict(name=k[:60], ms_per_step=round(ms, 3),
                                  calls_per_step=round(c, 1)) for k, ms, c in rows[:5]])


def _profile_row(reads, rows, n_steps):
    busy = sum(r[1] for r in rows)
    wall = reads[0][0]
    return dict(
        profiled_steps=n_steps, wall_ms_per_step=round(wall, 3),
        wall_ms_per_step_reads=[round(w, 3) for w, _ in reads],
        device_busy_ms_per_step=round(busy, 3) if rows else "not measured",
        device_idle_share=round(1.0 - busy / wall, 3) if rows else "not measured",
        device_calls_per_step=round(sum(r[2] for r in rows), 1),
        event_span_ms_per_step=round(reads[0][1], 3),
        top_kernels=[dict(name=k[:60], ms_per_step=round(ms, 3), calls_per_step=round(c, 1))
                     for k, ms, c in rows[:8]])


def phase_profile(seed: int, params) -> dict:
    """Where a serving step's time goes: the 32-layer engine with all 8 slots
    busy, in the default (fused) configuration, prefill-width steps, then
    decode steps (the unfused configuration is driven by `serve_unfused`,
    not profiled here); each through the step's CUDA graph and
    through the engine's eager body, in turns (graph, eager, eager, graph)
    on the same engine —
    wall time per step on the host's clock, the card's busy time under
    torch.profiler, the idle share, the kernels that take it, and each
    width's capture time. torch.profiler must see the kernels inside a
    replay: a graph step must show at least the eager step's calls per step;
    where it does not, its device time is the CUDA-event span around the
    steps, and the line says so. Returns the graph decode step's inputs and
    measurements (its engine config, device ms, peak bytes over the decode
    steps, the bytes of its params, pools and upload) for `dryrun`."""
    from repro_torch.launch.engine import EngineConfig, build_engine

    ecfg = EngineConfig(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=256,
                        max_blocks_per_slot=32)
    # 13 prefill-width steps (416 / 32) and 47 decode steps at most per engine:
    # one warm-up step per width, then per configuration 4 turns of n_wall
    # steps and 2 profiled runs of n_prof + 1 steps
    prompt_len, n_pre, n_dec = 416, (1, 2), (6, 3)
    engine, _ = build_engine("llama2-7b", use_reduced=False, lcd=True, ecfg=ecfg,
                             seed=seed, params=params, device="cuda")
    rng = np.random.default_rng(seed)
    for _ in range(8):
        engine.submit(rng.integers(0, engine.model.cfg.vocab, prompt_len),
                      max_new_tokens=48)
    engine.step()                        # the prefill width's warm-up and capture

    def turns(engine, n, key, out):
        (n_wall, n_prof), width = n, 32 if key.startswith("prefill") else 1
        ran = engine.traces.get(width, 0)
        reads = {False: [], True: []}
        for eager in (False, True, True, False):
            reads[eager].append(_wall_ms_per_step(engine, n_wall, eager))
        for eager, name in ((False, key), (True, key + "_eager")):
            out[name] = _profile_row(reads[eager], _profile_steps(engine, n_prof, eager),
                                     n_prof)
        steps = 4 * n_wall + 2 * (n_prof + 1)
        if engine.traces.get(width, 0) - ran != steps or any(r is None for r in engine.slots):
            raise SystemExit(f"profile: {key}: not every step was of width {width} with "
                             f"all 8 slots busy")

    out = {}
    turns(engine, n_pre, "prefill_width_32", out)
    while any(r is not None and r.prefilling for r in engine.slots):
        engine.step()
    engine.step()                        # the decode width's warm-up and capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the graph decode step's inputs (params, pools, the width-1 upload); what
    # else the process holds at the reset (earlier phases' tensors) is taken
    # out of the peak, so that it is the decode steps' own
    input_bytes = _storage_bytes(engine.params, engine.caches, engine._graphs._uploads[1].dev)
    other = torch.cuda.memory_allocated() - input_bytes
    turns(engine, n_dec, "decode_width_1", out)
    decode_peak = torch.cuda.max_memory_allocated() - other
    # an eager profile can drop a few kernel records (3,633 of 3,637 a step
    # were seen) but never adds one: a graph step that shows at least the
    # eager step's calls shows every kernel of its replay
    calls = {k: (out[k]["device_calls_per_step"], out[k + "_eager"]["device_calls_per_step"])
             for k in ("prefill_width_32", "decode_width_1")}
    seen = all(0 < graph >= eager for graph, eager in calls.values())
    if not seen:
        for k in ("prefill_width_32", "decode_width_1"):
            row = out[k]
            row["device_busy_ms_per_step"] = row["event_span_ms_per_step"]
            row["device_idle_share"] = round(1.0 - row["event_span_ms_per_step"]
                                             / row["wall_ms_per_step"], 3)
            row["device_time_from"] = ("CUDA events around the steps, profiler off: the "
                                       "profiler does not see every kernel of a replay")
    capture_s = {str(w): round(c, 3) for w, c in engine._graphs.capture_seconds().items()}
    # the graph decode step's inputs and measurements, for the dry run's check
    drive = dict(
        ecfg=ecfg, device_ms=(out["decode_width_1"]["device_busy_ms_per_step"] if seen else
                              out["decode_width_1"]["event_span_ms_per_step"]),
        device_ms_from=out["decode_width_1"].get("device_time_from", "torch.profiler"),
        peak_bytes=decode_peak, input_bytes=input_bytes)
    emit("profile", arch="llama2-7b", layers=32, slots=8, prompt_len=prompt_len,
         profiler_sees_graph_kernels=seen,
         calls_per_step_graph_and_eager={k: list(v) for k, v in calls.items()},
         graph_capture_s=capture_s, **out)
    return drive


# ---------------------------------------------------------------------------
# speculative self-drafting
# ---------------------------------------------------------------------------

SPEC_K = 3


def _spec_expected_launches(n_layers, traces, k, mlp="swiglu"):
    """LUT and attention launches of the speculative engine's graphs, fused:
    the prefill step runs both models (M = 256: B4 / B2), a round k + 1
    draft feeds (M = 8) and one verify (M = 8 (k + 1) < 128: the GEMVs B3 /
    B1), each feed per layer the multi and solo launches of
    `_lut_launches_per_layer` and one attention."""
    pre = traces.get(("prefill", 32), 0)
    feeds = traces.get(("draft", k), 0) * (k + 1) + traces.get(("verify", k + 1), 0)
    multi, solo = _lut_launches_per_layer(True, mlp)
    return {"lut_matmul_fused_multi_gemv": multi * n_layers * feeds,
            "lut_matmul_fused_multi": 2 * multi * n_layers * pre,
            "lut_matmul_fused_gemv": solo * n_layers * feeds,
            "lut_matmul_fused": 2 * solo * n_layers * pre,
            "paged_pool_attention": n_layers * (2 * pre + feeds), **NOT_SERVING}


def _row_count_ops(model, params, k):
    """Whether the PyTorch ops of a step give a row the same bits at S (k + 1)
    rows (the verify) and at S * 32 (a mixed step) as at S rows (a decode
    step): both norms (`layers._stat_rows`), the model's vocab head as one
    product over every window position with its final softcap, and the int8
    pool's absmax quantizer. Returns (those ops, all must hold; the plain f32
    `torch.mean` the norms took their statistics with before, which does not
    hold, and is why `layers._MIN_STAT_ROWS` exists). With `k` None (a
    recurrent family, which neither verifies nor feeds more than S rows at
    once) those are skipped; a recurrent family adds `_recurrent_row_ops`
    and the audio family `_audio_row_ops` ("slot_1_of_8")."""
    from repro_torch.models.layers import layernorm, quantize_kv, rmsnorm
    from repro_torch.models.transformer import lm_head_logits
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(5)
    scale = torch.randn((cfg.d_model,), generator=gen, device="cuda").mul_(0.1)
    bias = torch.randn((cfg.d_model,), generator=gen, device="cuda").mul_(0.1)
    ops, raw = {}, {}
    if cfg.family in RECURRENT_FAMILIES:
        ops["slot_1_of_8"] = _recurrent_row_ops(model, params)
    if cfg.family == "audio":
        ops["slot_1_of_8"] = _audio_row_ops(model, params)
    with torch.no_grad():
        for t in (k + 1, 32) if k is not None else ():
            x = torch.randn((8, t, cfg.d_model), generator=gen, device="cuda").mul_(3)
            x = x.to(cfg.torch_dtype)
            cols = [x[:, j:j + 1].contiguous() for j in range(t)]

            def same(fn):
                wide = fn(x)
                return all(torch.equal(wide[:, j:j + 1], fn(c)) for j, c in enumerate(cols))
            kv = torch.randn((8, t, cfg.n_kv_heads, cfg.hd), generator=gen,
                             device="cuda").to(cfg.torch_dtype)
            sm = 0.5 + torch.rand((cfg.n_kv_heads, cfg.hd), generator=gen, device="cuda")
            q, sc = quantize_kv(kv.reshape(8 * t, cfg.n_kv_heads, cfg.hd), sm)
            q, sc = q.view(8, t, -1, cfg.hd), sc.view(8, t, -1)
            per_pos = [quantize_kv(kv[:, j].contiguous(), sm) for j in range(t)]
            ops[f"rows_{8 * t}"] = {
                "rmsnorm": same(lambda a: rmsnorm(a, scale)),
                "layernorm": same(lambda a: layernorm(a, 1.0 + scale, bias)),
                "lm_head_one_product": same(lambda a: lm_head_logits(params, a, cfg)),
                "quantize_kv": all(torch.equal(q[:, j], a) and torch.equal(sc[:, j], b)
                                   for j, (a, b) in enumerate(per_pos)),
            }
            raw[f"rows_{8 * t}"] = same(lambda a: torch.mean(
                a.float() * a.float(), dim=-1, keepdim=True))
    return ops, raw


def _row_count_ops_hold(ops) -> bool:
    return all(v for rows in ops.values() for v in rows.values())


def _drive_counting_rounds(engine, prompts, new_tokens, k):
    """`_drive`, and for every request in every round it joined whether the
    round emitted all it could: k + 1 tokens, or the request's whole
    remaining budget where that was smaller (a capped round). What an
    identical draft must do in every round."""
    full = []
    inner = engine._spec_round

    def spy(active):
        left = {r.rid: (r.max_new_tokens - len(r.out_tokens), len(r.accept_lens))
                for _, r in active}
        done = inner(active)
        for _, r in active:
            budget, n = left[r.rid]
            if len(r.accept_lens) > n:             # it joined the round
                full.append(r.accept_lens[-1] + 1 == min(k + 1, budget))
        return done

    engine._spec_round = spy
    try:
        requests = _drive(engine, prompts, new_tokens)
    finally:
        del engine._spec_round
    return requests, full


def _replay_ms(captured, n=20) -> float:
    """Device milliseconds of one replay of a captured graph, by CUDA events
    around `n` back-to-back replays (counted nowhere: `graph.replay` directly)."""
    captured.graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        captured.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _graph_ms_at_full_batch(engine, seed, keys):
    """Device ms of one replay of each graph in `keys` with all 8 slots
    decoding (prompts of 96 tokens): the engine steps until every slot has
    decoded at least once, the graphs are replayed on the last upload (the
    same writes again: a replay is idempotent there), then the drive ends."""
    cfg = engine.model.cfg
    rng = np.random.default_rng(seed + 11)
    reqs = [engine.submit(rng.integers(0, cfg.vocab, 96).astype(np.int32), 40)
            for _ in range(engine.ecfg.num_slots)]
    while not all(r.state == "running" and len(r.out_tokens) >= 2 for r in reqs):
        engine.step()
    out = {str(key): round(_replay_ms(engine._graphs._graphs[key]), 4) for key in keys}
    engine.run()
    return out


# serve_spec's depth: llama2-7b cut to 2 layers (4 -> 2 for the 820 s mark
# when every family came to train on a mesh: the draft's re-clustering takes
# ~3.6 s a layer)
SPEC_LAYERS = 2


def phase_serve_spec(seed: int):
    """Speculative self-drafting on LCD 4-bit llama2-7b at full width, cut to
    SPEC_LAYERS: the 2-bit self-draft made on the card (`make_draft_params`),
    the speculative engine (k = 3) and the plain one over the same prompts,
    driven in turns (spec, plain, plain, spec): the same tokens for every
    request, launch counts per role, bounded shapes. Then every replay of
    the three graphs against their eager bodies with the verify's rows held
    to width-1 steps (`_graph_check`), the identical draft (every uncapped
    round accepts k), the draft's packing, and the device ms of one draft and
    one verify graph with 8 slots decoding."""
    from repro_torch.core.clustered_params import (_clustered_leaves, make_draft_params,
                                                   packed_weight_bytes)
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import EngineConfig, ServingEngine, build_engine

    n_layers, k, new_tokens = SPEC_LAYERS, SPEC_K, 24
    model, params = _served_params("llama2-7b", seed, n_layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draft, report = make_draft_params(params, draft_centroids=4)
    torch.cuda.synchronize()
    draft_s = time.perf_counter() - t0

    leaves = _clustered_leaves(draft)
    draft_bytes, int4_bytes = packed_weight_bytes(draft), packed_weight_bytes(draft, nbits=4)
    packing_ok = (all(c.nbits == 2 for c in leaves) and len(leaves) == 7
                  and 2 * draft_bytes <= int4_bytes)

    base = dict(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=256,
                max_blocks_per_slot=32)
    plain = ServingEngine(model, params, EngineConfig(**base), device="cuda")
    spec, _ = build_engine("llama2-7b", use_reduced=False, lcd=True, n_layers=n_layers,
                           ecfg=EngineConfig(speculative_k=k, **base), params=params,
                           draft_params=draft, device="cuda")
    cfg = model.cfg
    prompts = _serve_prompts(cfg.vocab, seed, 12)

    turns, tokens, counts, traces = [], {}, None, None
    for engine, name in ((spec, "spec"), (plain, "plain"), (plain, "plain"), (spec, "spec")):
        torch.cuda.synchronize()
        if counts is None:
            reset_launch_counts()
        t0 = time.perf_counter()
        requests = _drive(engine, prompts, new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if counts is None:
            counts, traces = launch_counts(), dict(spec.traces)
        n_tok = sum(len(r.out_tokens) for r in requests)
        turns.append((name, round(n_tok / wall, 2)))
        tokens.setdefault(name, []).append([list(r.out_tokens) for r in requests])
    spec.assert_bounded_traces()
    plain.assert_bounded_traces()
    want_keys = {("prefill", 32), ("draft", k), ("verify", k + 1)}
    expected = _spec_expected_launches(n_layers, traces, k)
    same = all(t == tokens["plain"][0] for runs in tokens.values() for t in runs)
    finished = all(len(t) == new_tokens for t in tokens["spec"][0])
    summary = spec.acceptance_summary()
    capture_s = {str(key): round(c, 3) for key, c in spec._graphs.capture_seconds().items()}

    # the identical draft: every round whose budget is not capped accepts k
    full = ServingEngine(model, params, EngineConfig(speculative_k=k, **base),
                         draft_params=params, device="cuda")
    full_reqs, rounds_full = _drive_counting_rounds(full, prompts, new_tokens, k)
    full_same = [list(r.out_tokens) for r in full_reqs] == tokens["plain"][0]
    full_accept = bool(rounds_full) and all(rounds_full)
    full_summary = full.acceptance_summary()
    del full

    graph_ms = _graph_ms_at_full_batch(spec, seed, (("draft", k), ("verify", k + 1)))
    graph_ms.update(_graph_ms_at_full_batch(plain, seed, (1,)))
    rows, raw_mean = _row_count_ops(model, params, k)
    ok = (same and finished and counts == expected and set(traces) == want_keys
          and packing_ok and full_same and full_accept and _row_count_ops_hold(rows)
          and all(counts[n] > 0 for n in expected if n not in NOT_SERVING))
    emit("serve_spec", arch="llama2-7b", layers=n_layers, dtype=cfg.dtype, weight_bits=4,
         draft_bits=2, speculative_k=k, requests=len(prompts), new_tokens_each=new_tokens,
         prompt_lens=[len(p) for p in prompts],
         tokens_per_s_turns=turns, spec_tokens_equal_plain=same,
         acceptance_summary=summary, traces={str(key): c for key, c in traces.items()},
         launches=counts, launches_expected=expected,
         identical_draft=dict(tokens_equal_plain=full_same, every_round_emits_all_it_can=full_accept,
                              slot_rounds=len(rounds_full), acceptance_summary=full_summary),
         draft=dict(make_draft_params_s=round(draft_s, 2), packed_bytes=draft_bytes,
                    int4_layout_bytes=int4_bytes, all_2_bit=packing_ok,
                    summary=report.summary()),
         device_ms_per_graph_8_slots=graph_ms, graph_capture_s=capture_s,
         row_count_ops_same_bits=rows, unrepeated_torch_mean_f32_same_bits=raw_mean,
         peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    if not ok:
        raise SystemExit(f"serve_spec: tokens, launch counts, shapes or the draft are wrong: "
                         f"same={same} full_same={full_same} full_accept={full_accept} "
                         f"packing={packing_ok} traces={traces} row-count ops={rows} "
                         f"{counts} vs {expected}")
    # every replay of the three graphs against the eager bodies, verify rows included
    _graph_check("serve_spec", spec, seed)
    del spec
    # the same draft on a (1, 2) mesh of the card: plain greedy's tokens
    on_mesh = ServingEngine(model, params, EngineConfig(speculative_k=k, **base),
                            mesh=_mesh_of((1, 2)), draft_params=draft, device="cuda")
    mesh_tokens = [list(r.out_tokens) for r in _drive(on_mesh, prompts, new_tokens)]
    on_mesh.assert_bounded_traces()
    same_on_mesh = mesh_tokens == tokens["plain"][0]
    emit("serve_spec_mesh", mesh=on_mesh.mesh.shape, speculative_k=k,
         tokens_equal_plain=same_on_mesh, acceptance_summary=on_mesh.acceptance_summary())
    if not same_on_mesh:
        raise SystemExit("serve_spec: on the (1, 2) mesh the speculative engine's tokens "
                         "differ from plain greedy's")
    _graph_check("serve_spec_mesh_1x2", on_mesh, seed)
    return counts


def _serve_spec_arch(arch, seed, n_layers=2, k=SPEC_K, new_tokens=16):
    """Speculative self-drafting on one arch at full width cut to `n_layers`:
    its 2-bit draft made on the card, the speculative engine (k = 3) and the
    plain one over the same 8 staggered requests: the same tokens, launch
    counts per role, bounded shapes, the row-count ops of `_row_count_ops`
    over this arch's width and head (final softcap included), then every
    replay against its eager body with the verify's rows torch.equal to
    width-1 steps (`_graph_check`). Returns the speculative drive's
    launches."""
    from repro_torch.core.clustered_params import make_draft_params
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import EngineConfig, ServingEngine, build_engine

    model, params = _served_params(arch, seed, n_layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draft, report = make_draft_params(params, draft_centroids=4)
    torch.cuda.synchronize()
    draft_s = time.perf_counter() - t0
    base = dict(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=256,
                max_blocks_per_slot=32)
    plain = ServingEngine(model, params, EngineConfig(**base), device="cuda")
    spec, _ = build_engine(arch, use_reduced=False, lcd=True, n_layers=n_layers,
                           ecfg=EngineConfig(speculative_k=k, **base), params=params,
                           draft_params=draft, device="cuda")
    cfg = model.cfg
    prompts = _serve_prompts(cfg.vocab, seed, 8)
    want = [list(r.out_tokens) for r in _drive(plain, prompts, new_tokens)]
    torch.cuda.synchronize()
    reset_launch_counts()
    got = [list(r.out_tokens) for r in _drive(spec, prompts, new_tokens)]
    torch.cuda.synchronize()
    counts, traces = launch_counts(), dict(spec.traces)
    spec.assert_bounded_traces()
    expected = _spec_expected_launches(n_layers, traces, k, _mlp_kind(cfg))
    rows, raw_mean = _row_count_ops(model, params, k)
    ok = (got == want and all(len(t) == new_tokens for t in got) and counts == expected
          and set(traces) == {("prefill", 32), ("draft", k), ("verify", k + 1)}
          and _row_count_ops_hold(rows)
          and all(counts[n] > 0 for n in expected if n not in NOT_SERVING))
    emit("serve_spec_family", arch=arch, layers=n_layers, speculative_k=k,
         requests=len(prompts), new_tokens_each=new_tokens, spec_tokens_equal_plain=got == want,
         acceptance_summary=spec.acceptance_summary(),
         traces={str(key): c for key, c in traces.items()}, launches=counts,
         launches_expected=expected,
         draft=dict(make_draft_params_s=round(draft_s, 2), summary=report.summary()),
         row_count_ops_same_bits=rows, unrepeated_torch_mean_f32_same_bits=raw_mean,
         peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    if not ok:
        raise SystemExit(f"serve_spec_family: {arch}: tokens, launch counts, shapes or the "
                         f"row-count ops are wrong: same={got == want} rows={rows} "
                         f"traces={traces} {counts} vs {expected}")
    _graph_check("serve_spec_family", spec, seed)
    return counts


# the family's speculative drives, one for each layer shape of FAMILY, with
# their depths: gemma2-27b at 2 (a sliding-window and a global layer, the
# softcaps), starcoder2-15b (the non-gated gelu MLP with biases, layernorm,
# QKV bias), stablelm-12b (layernorm, head_dim 160) and paligemma-3b (MQA,
# head_dim 256) at 1 layer each, cut from 2 for the chip script's time
SPEC_FAMILY = (("gemma2-27b", 2), ("starcoder2-15b", 1), ("stablelm-12b", 1),
               ("paligemma-3b", 1))


def phase_serve_spec_family(seed: int) -> dict:
    """`_serve_spec_arch` for each arch of SPEC_FAMILY at full width, at its
    depth."""
    total = {}
    for arch, layers in SPEC_FAMILY:
        t0 = time.perf_counter()
        for n, c in _serve_spec_arch(arch, seed, n_layers=layers).items():
            total[n] = total.get(n, 0) + c
        emit("serve_spec_family_arch", arch=arch, layers=layers,
             seconds=round(time.perf_counter() - t0, 1))
    return total


# ---------------------------------------------------------------------------
# the engine's production features: prefix cache with copy-on-write, the
# priority / weighted-fair scheduler, chunked-prefill admission
# ---------------------------------------------------------------------------

# the shared system prompt: 9 blocks of 16 tokens but 4.5 prefill chunks of 32,
# so the cache-on run cuts every tail into other chunks than the cache-off run
SYSTEM_PROMPT_LEN = 144
# the per-block pool tensors a copy-on-write copies (the smoothing vectors are
# per layer, not per block)
COW_TENSORS = ("k", "v", "k_scale", "v_scale")


def _prefix_traffic(cfg, seed, n=12):
    """(main, bare): `n` prompts that open with one 144-token system prompt and
    end in a tail of 8-56 random tokens, and twice the bare system prompt,
    which is block-aligned and fully cached once the main drive has run, so
    its last token is re-fed into a shared block: a copy-on-write."""
    rng = np.random.default_rng(seed + 21)
    system = rng.integers(0, cfg.vocab, SYSTEM_PROMPT_LEN).astype(np.int32)
    main = [np.concatenate([system, rng.integers(0, cfg.vocab, int(rng.integers(8, 57)))
                            .astype(np.int32)]) for _ in range(n)]
    return main, [system.copy(), system.copy()]


def _cow_watch(engine):
    """Wrap the engine's copy-on-write copy and its step: right after every
    copy, whether the new block is torch.equal to its source in every pool
    tensor copied (the draft's too), and after the next step whether each
    source is still what it was at the copy (the writer wrote into its own
    copy). Returns the record; `_cow_unwatch` takes the wrappers off."""
    seen = dict(copies=0, equal_after_copy=[], source_kept_after_step=[], pools=set())
    pending = []
    inner_copy, inner_step = engine._cow_copy, engine.step

    def copy(src, dst):
        inner_copy(src, dst)
        seen["copies"] += 1
        for tag, caches in (("target", engine.caches), ("draft", engine.draft_caches)):
            if caches is None:
                continue
            for name in COW_TENSORS:
                t = caches["paged"].get(name)
                if t is not None:
                    seen["equal_after_copy"].append(torch.equal(t[:, dst], t[:, src]))
                    seen["pools"].add(f"{tag} {name}")
                    pending.append((t, src, t[:, src].clone()))

    def step():
        done = inner_step()
        while pending:
            t, src, before = pending.pop()
            seen["source_kept_after_step"].append(torch.equal(t[:, src], before))
        return done

    engine._cow_copy, engine.step = copy, step
    return seen


def _cow_unwatch(engine, seen):
    engine.__dict__.pop("_cow_copy", None)
    engine.__dict__.pop("step", None)
    return dict(copies=seen["copies"], pools=sorted(seen["pools"]),
                equal_after_copy=bool(seen["equal_after_copy"])
                and all(seen["equal_after_copy"]),
                source_kept_after_step=bool(seen["source_kept_after_step"])
                and all(seen["source_kept_after_step"]))


def _cow_copy_ms(engine, n=20):
    """(device ms of one copy-on-write copy, its byte bound in ms): the
    engine's own `_cow_copy` between `n` distinct pairs of free blocks (n x
    the bytes of a block pair pass through a 50 MB L2, so each copy finds its
    source cold), captured and replayed by `time_ms`. The bound reads every
    per-block pool tensor's block once and writes it once, over 3.35 TB/s."""
    free = list(engine.alloc._free)
    pairs = [(free[2 * i], free[2 * i + 1]) for i in range(n)]
    traces = dict(engine.traces)
    ms = time_ms(lambda i: engine._cow_copy(*pairs[i]), n)
    engine.traces.clear()
    engine.traces.update(traces)            # the timing's copies are no engine step
    nbytes = sum(2 * t[:, 0].numel() * t.element_size()
                 for caches in (engine.caches, engine.draft_caches) if caches is not None
                 for name, t in caches["paged"].items() if name in COW_TENSORS)
    return ms, nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def _ttft_ms(requests):
    """Time to first token per request, `first_token_t - submit_t` on the
    engine's host clock, as {p50, p99, each} in ms."""
    ttft = [(r.first_token_t - r.submit_t) * 1e3 for r in requests]
    return dict(p50=round(float(np.percentile(ttft, 50)), 3),
                p99=round(float(np.percentile(ttft, 99)), 3),
                each=[round(t, 1) for t in ttft])


def _prefix_pair(name, seed, n_layers, params, *, kv_dtype=None, spec_k=0, new_tokens=24,
                 graph_check=False, cow_ms=False):
    """The same prefix traffic (`_prefix_traffic`) through two engines of the
    `serve` geometry built by `build_engine` on `params`: the plain engine
    with the prefix cache off, then the cache on (with `spec_k`, speculative
    over the 2-bit draft made on the card). Each drive: the 12 prompts one
    every other step (timed, launch counts from zero), then after the drain
    the two bare system prompts (the copy-on-write, watched by `_cow_watch`
    on the cache-on engine). Checks tokens equal request for request, at
    least one copy (in both pools with speculation), a reuse rate above 0,
    bounded shapes, launch counts against the run's own widths, the
    allocator's conservation after the drain; with `graph_check` every replay
    against its eager body after the copies; with `cow_ms` the copy's device
    time. Returns the cache-on main drive's launch counts."""
    from repro_torch.core.clustered_params import make_draft_params
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import EngineConfig, build_engine

    base = dict(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=256,
                max_blocks_per_slot=32, kv_dtype=kv_dtype)
    draft, draft_s = None, None
    if spec_k:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draft, _ = make_draft_params(params, draft_centroids=4)
        torch.cuda.synchronize()
        draft_s = round(time.perf_counter() - t0, 2)
    kv_smooth, runs = None, {}
    for cache in (False, True):
        ecfg = EngineConfig(prefix_cache=cache, speculative_k=spec_k if cache else 0, **base)
        engine, _ = build_engine("llama2-7b", use_reduced=False, lcd=True, ecfg=ecfg,
                                 params=params, draft_params=draft if cache else None,
                                 kv_smooth=kv_smooth, n_layers=n_layers, device="cuda")
        if kv_dtype == "int8" and kv_smooth is None:   # calibrated once, on the card
            pool = engine.caches["paged"]
            kv_smooth = (pool["k_smooth"].cpu().numpy(), pool["v_smooth"].cpu().numpy())
        cfg = engine.model.cfg
        main, bare = _prefix_traffic(cfg, seed)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        requests = _drive(engine, main, new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, widths = launch_counts(), dict(engine.traces)
        if spec_k and cache:
            expected = _spec_expected_launches(n_layers, widths, spec_k)
        else:
            expected = _expected_launches(True, n_layers, widths)
        watch = _cow_watch(engine) if cache else None
        tail = _drive(engine, bare, new_tokens)
        run = dict(tokens=[list(r.out_tokens) for r in requests + tail],
                   tokens_per_s=round(sum(len(r.out_tokens) for r in requests) / wall, 2),
                   wall_s=round(wall, 3), ttft_ms=_ttft_ms(requests),
                   launches_as_expected=counts == expected and all(
                       c > 0 for n, c in expected.items() if n not in NOT_SERVING),
                   widths={str(w): c for w, c in engine.traces.items()})
        engine.assert_bounded_traces()
        if cache:
            run["cow"] = _cow_unwatch(engine, watch)
            run["report"] = engine.prefix_cache_report()
            run["cached_tokens_per_request"] = [r.cached_tokens for r in requests + tail]
            run["conserved"] = engine.alloc.num_free + engine.alloc.num_cached == base["num_blocks"]
            run["launches"] = counts
            if cow_ms:
                ms, bound, nbytes = _cow_copy_ms(engine)
                run["cow_copy"] = dict(device_ms=round(ms, 5), bound_ms=round(bound, 5),
                                       bytes=nbytes, bound_by="bytes", copies_timed=20)
            if graph_check:
                _graph_check(name, engine, seed)
            if spec_k:
                run["acceptance_summary"] = engine.acceptance_summary()
        runs["on" if cache else "off"] = run
        del engine
    off, on = runs["off"], runs["on"]
    same = on["tokens"] == off["tokens"]
    pools = {"target k", "target v"} | ({"draft k", "draft v"} if spec_k else set())
    ok = (same and all(len(t) == new_tokens for t in on["tokens"])
          and off["launches_as_expected"] and on["launches_as_expected"]
          and on["report"]["cow_copies"] >= 1 and "cow" in on["widths"]
          and on["report"]["block_reuse_rate"] > 0 and on["conserved"]
          and on["cow"]["copies"] >= 1 and pools <= set(on["cow"]["pools"])
          and on["cow"]["equal_after_copy"] and on["cow"]["source_kept_after_step"])
    emit(name, arch="llama2-7b", layers=n_layers, kv_dtype=kv_dtype or "float",
         speculative_k=spec_k, draft_s=draft_s, requests=len(off["tokens"]),
         system_prompt_tokens=SYSTEM_PROMPT_LEN, new_tokens_each=new_tokens,
         tokens_equal_cache_off=same, ok=ok,
         **{f"cache_{k}": {f: v for f, v in run.items() if f not in ("tokens",)}
            for k, run in runs.items()},
         peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    if not ok:
        raise SystemExit(f"{name}: cache on != cache off, or a copy-on-write, launch or "
                         f"allocator check failed (tokens equal: {same}); see the line above")
    return on["launches"]


def phase_serve_prefix(seed: int, params) -> dict:
    """Prefix caching on LCD 4-bit llama2-7b at full width and depth, on the
    `serve` phase's weights: cache on = cache off, the copy-on-write, every
    replay = its eager body after the copies, the copy's device time."""
    return _prefix_pair("serve_prefix", seed, 32, params, graph_check=True, cow_ms=True)


def phase_serve_prefix_spec(seed: int, params) -> dict:
    """The same traffic on the first 2 layers, speculative (k = 3, the 2-bit
    draft made on the card) with the cache on against plain with it off."""
    return _prefix_pair("serve_prefix_spec", seed, 2, _first_layers(params, 2),
                        spec_k=SPEC_K, graph_check=True)


def phase_serve_prefix_int8(seed: int, params) -> dict:
    """The same traffic on the first 4 layers over the int8 pool: a copy
    carries the per-token scales with the codes."""
    return _prefix_pair("serve_prefix_int8", seed, 4, _first_layers(params, 4), kv_dtype="int8")


SCHED_WEIGHTS = {"a": 1.0, "b": 2.0}
SCHED_BUDGET = 600


def _reference_pick(queue, inflight, served, weights, budget):
    """The reference scheduler's "priority" pick (its `_pick_next`), on the
    host over the port's queued requests: among requests whose tenant stays
    within `budget` (feed = prompt + generated, plus the tokens still to
    generate), the highest priority, then the smallest served / weight share
    of its tenant, then arrival."""
    def need(r):
        return len(r.prompt) + r.max_new_tokens

    eligible = [r for r in queue
                if budget is None or inflight.get(r.tenant, 0) + need(r) <= budget]
    if not eligible:
        return None
    return min(eligible, key=lambda r: (-r.priority, served.get(r.tenant, 0)
                                        / weights.get(r.tenant, 1.0), r.rid))


def _first_wave(requests, slots, budget):
    """The first admission wave of a burst, replayed on the host: the
    reference rule's picks (`_reference_pick`, nothing served yet) as long as
    a slot is free and a request fits its tenant's budget (chunked
    admission's first-chunk grants leave the pool no say here). Returns the
    picked rids in order."""
    queue, inflight, order = list(requests), {}, []
    while queue and len(order) < slots:
        r = _reference_pick(queue, inflight, {}, {}, budget)
        if r is None:
            break
        queue.remove(r)
        inflight[r.tenant] = inflight.get(r.tenant, 0) + len(r.prompt) + r.max_new_tokens
        order.append(r.rid)
    return order


def phase_serve_sched(seed: int, params) -> dict:
    """The priority / weighted-fair scheduler with chunked-prefill admission
    on the first 4 layers of the `serve` weights, under pool pressure (64
    blocks for 8 slots: the run must preempt): 12 requests in one burst, two
    tenants weighted {a: 1, b: 2} under a token budget that defers
    admissions, priorities 0-2. Every pick is held to the reference's rule over the same queue and
    tenant state (`_reference_pick`), the first wave to a host-only replay
    (`_first_wave`); each request's tokens equal its solo run; launch counts
    against the run's widths. Returns the drive's launch counts."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import EngineConfig, build_engine

    n_layers, new_tokens = 4, 24
    params = _first_layers(params, n_layers)
    ecfg = EngineConfig(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=64,
                        max_blocks_per_slot=32, chunked_prefill=True, scheduler="priority",
                        tenant_weights=SCHED_WEIGHTS, tenant_token_budget=SCHED_BUDGET)
    engine, _ = build_engine("llama2-7b", use_reduced=False, lcd=True, ecfg=ecfg,
                             params=params, n_layers=n_layers, device="cuda")
    cfg = engine.model.cfg
    prompts = _serve_prompts(cfg.vocab, seed + 31, 12)
    tags = [dict(tenant="ab"[i % 2], priority=i % 3) for i in range(12)]
    seen = dict(picks=0, mismatches=[], deferred=0)
    order = []
    inner_pick, inner_acquire = engine._pick_next, engine._tenant_acquire

    def pick():
        want = _reference_pick(list(engine.queue), dict(engine._tenant_inflight),
                               dict(engine._tenant_served), SCHED_WEIGHTS, SCHED_BUDGET)
        got = inner_pick()
        seen["picks"] += 1
        if got is not want:
            seen["mismatches"].append((None if got is None else got.rid,
                                       None if want is None else want.rid))
        seen["deferred"] += int(got is None and bool(engine.queue))
        return got

    def acquire(r):
        if r.rid not in order:
            order.append(r.rid)
        inner_acquire(r)

    engine._pick_next, engine._tenant_acquire = pick, acquire
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    requests = [engine.submit(p, new_tokens, **kw) for p, kw in zip(prompts, tags)]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, widths = launch_counts(), dict(engine.traces)
    engine.__dict__.pop("_pick_next")
    engine.__dict__.pop("_tenant_acquire")
    engine.assert_bounded_traces()
    expected = _expected_launches(True, n_layers, widths)
    served = dict(engine._tenant_served)
    first = _first_wave(requests, ecfg.num_slots, SCHED_BUDGET)
    tokens = [list(r.out_tokens) for r in requests]
    del engine
    solo_engine, _ = build_engine("llama2-7b", use_reduced=False, lcd=True, ecfg=ecfg,
                                  params=params, n_layers=n_layers, device="cuda")
    solo = []
    for p in prompts:                   # one at a time: each request alone in the engine
        r = solo_engine.submit(p, new_tokens)
        solo_engine.run()
        solo.append(list(r.out_tokens))
    del solo_engine
    ok = (tokens == solo and all(len(t) == new_tokens for t in tokens)
          and not seen["mismatches"] and seen["deferred"] >= 1
          and sum(r.preemptions for r in requests) >= 1
          and order[:len(first)] == first and order != sorted(order)
          and counts == expected
          and all(c > 0 for n, c in expected.items() if n not in NOT_SERVING))
    emit("serve_sched", arch="llama2-7b", layers=n_layers, ok=ok, requests=len(prompts),
         new_tokens_each=new_tokens, num_blocks=ecfg.num_blocks,
         tenant_weights=SCHED_WEIGHTS, tenant_token_budget=SCHED_BUDGET,
         requests_meta=[dict(rid=r.rid, prompt=len(r.prompt), **t)
                        for r, t in zip(requests, tags)],
         admission_order=order, first_wave_replayed=first,
         picks_held_to_reference=seen["picks"], pick_mismatches=seen["mismatches"],
         deferred_admissions=seen["deferred"],
         preemptions=sum(r.preemptions for r in requests), tenant_served_tokens=served,
         tokens_equal_solo=tokens == solo, tokens_per_s=round(sum(map(len, tokens)) / wall, 2),
         widths={str(w): c for w, c in widths.items()}, launches=counts,
         launches_expected=expected,
         peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    if not ok:
        raise SystemExit(f"serve_sched: the picks, the first wave, solo tokens or launch "
                         f"counts are wrong: {seen} order={order} first={first}")
    return counts


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the trainer and the paper's pipeline (train, checkpoint, compress under the
# empirical Fisher, evaluate, serve the student)
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 512, 30
TRAIN_OPT = dict(lr=3e-4, warmup_steps=5, total_steps=TRAIN_STEPS)
# model_parity's standard for f32 logits with the float transform
STUDENT_TOL_MAX, STUDENT_TOL_MEAN = 1e-3, 1e-4
# the leaf whose Fisher is held on the card against a plain computation
# outside compress_model (the squared gradient of that leaf alone, by
# autograd, over the same calibration batches), to FISHER_TOL of its largest
FISHER_PATH, FISHER_TOL = "['blocks']['attn']['wq']", 1e-4
# the codebook fine-tune (examples/distill_llm.py ft_step): KD steps of the
# student against the teacher, at the example's OptConfig
FT_STEPS = 6
# the kernels of the projection's backward (they replace no TPU kernel): the
# pre-pass splitting an f32 operand into two bf16 parts, and the two products
# on the tensor cores over those parts
BACKWARD_KERNELS = ("split_bf16", "lut_matmul_t", "lut_codebook_grad")
# the backward kernels' shapes beyond llama's three at 4096 rows: (M, K, N,
# nbits) at 2 and 3 bits, whisper's width at a row count no tile divides, and
# a small case with N not a multiple of 8 (the element-by-element staging)
BACKWARD_EXTRA = ((512, 4096, 4096, 2), (512, 4096, 4096, 3), (4000, 1280, 5120, 4),
                  (130, 200, 100, 3))
# each backward kernel against its plain version's autograd on the card, to
# these fractions of the largest |gradient| of the leaf: dx and dsmooth are
# f32 sums of 4096-11008 terms in another order; dcodebook sums ~1e11
# products, the plain version's `index_put_` accumulating them serially
BACKWARD_TOL = {"dxs": 1e-4, "dx": 1e-4, "dsmooth": 1e-4, "dcodebook": 1e-3}
# the kernels the pipeline's path launches: B2 / B4 in the student's forward
# and its fine-tune, the backward kernels in the fine-tune, B1-B5 in its engine
MOE_PATH_KERNELS = PLAIN_LUT + ("paged_pool_attention",)
TRAIN_PATH_KERNELS = MOE_PATH_KERNELS + BACKWARD_KERNELS


def _on_card(batch):
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _rel_errs(compressed, dense, paths):
    """||dequant(W_l) - W_l|| / ||W_l|| per stacked slice of every path."""
    from repro_torch.core.api import _flatten_with_paths, clustered_dequant
    leaves, dl = dict(_flatten_with_paths(compressed)), dict(_flatten_with_paths(dense))
    return {p: [float((clustered_dequant(_slice_of(leaves[p], l)) - dl[p][l].float()).norm()
                      / dl[p][l].float().norm()) for l in range(dl[p].shape[0])]
            for p in paths}


def _split_tc_ms(m, k, n):
    """3 * 2*M*K*N operations at the bf16 tensor-core peak: the least time of
    the backward kernels, which take a product as three bf16 products."""
    return 3 * 2.0 * m * k * n / PEAK_OPS[torch.bfloat16] * 1e3


def _backward_case(gen, m, k, n, nbits=4) -> dict:
    """The backward kernels on one (M, K, N) projection: `split_bf16` on dY
    and on x / smooth torch.equal to its plain version; `lut_matmul_t` and
    `lut_codebook_grad` each called twice (torch.equal), held against the
    plain version's autograd of y = (x / smooth) @ codebook[codes] on the
    same card (to BACKWARD_TOL of the largest |gradient|), then timed
    beside their bound (the split's three products on the tensor cores; the
    f32 CUDA-core bound beside it), their plain versions (kernels/ref.py)
    and a yardstick: torch.matmul over the dequantised f32 weight (dY Wᵀ;
    Xsᵀ dY). A kernel's `ms` includes the splits it makes from f32 operands;
    `ms_given_split` takes dY's parts given, as the fine-tune's backward
    shares them between the two. Fails the run on a miss. Returns {kernel:
    case}."""
    from repro_torch.core.lut import unpack_codes
    from repro_torch.kernels.lut_matmul import lut_codebook_grad, lut_matmul_t, split_bf16
    from repro_torch.kernels.ref import (lut_codebook_grad_ref, lut_matmul_t_ref,
                                         split_bf16_ref)
    x, smooth, packed, cb = _lut_operands(gen, m, k, n, nbits, torch.float32, 1)
    smooth, packed, cb = smooth[0], packed[0], cb[0]
    dy = torch.randn((m, n), generator=gen, device=gen.device)
    xs = x / smooth
    dys = split_bf16(dy)
    split_same = all(torch.equal(a, b) for a, b in (
        *zip(dys, split_bf16_ref(dy)), *zip(split_bf16(x, smooth), split_bf16_ref(x, smooth))))
    dxs = lut_matmul_t(dy, packed, cb, nbits=nbits)
    dcb, dsm = lut_codebook_grad(x, dy, packed, cb, smooth, nbits=nbits)
    again = (lut_matmul_t(dy, packed, cb, nbits=nbits, dy_split=dys),
             *lut_codebook_grad(x, dy, packed, cb, smooth, nbits=nbits, dy_split=dys))
    torch.cuda.synchronize()
    xg, sg, cg = (t.clone().requires_grad_(True) for t in (x, smooth, cb))
    xsg = xg / sg
    w = cg[unpack_codes(packed, k, nbits).long()]
    want = dict(zip(("dxs", "dx", "dsmooth", "dcodebook"),
                    torch.autograd.grad(xsg @ w, (xsg, xg, sg, cg), dy)))
    del xg, sg, cg, xsg
    got = dict(dxs=dxs, dx=dxs / smooth, dsmooth=dsm, dcodebook=dcb)
    errs = {g: float((got[g] - want[g]).abs().max()) for g in got}
    tols = {g: BACKWARD_TOL[g] * float(want[g].abs().max()) for g in got}
    w = w.detach()
    del want, got
    same = {"lut_matmul_t": torch.equal(dxs, again[0]),
            "lut_codebook_grad": torch.equal(dcb, again[1]) and torch.equal(dsm, again[2])}
    tc_ms, f32_ms = _split_tc_ms(m, k, n), _f32_core_ms(m, k, n)
    cases = {}
    # the pre-pass on dY: 4 bytes read, 2 + 2 written an element
    t_bytes = m * n * 8 / HBM_BYTES_PER_S
    cases["split_bf16"] = dict(
        kernel="split_bf16", m=m, k=k, n=n, nbits=nbits, dtype="float32", shape="dy (M, N)",
        equal=split_same, max_abs_err=0.0,
        ms=time_ms(lambda i: split_bf16(dy), 3),
        plain_ms=time_ms(lambda i: split_bf16_ref(dy), 3), library_ms=None,
        bound_ms=t_bytes * 1e3, bound_by="bytes")
    if not split_same:
        emit("train_kernels", failed=cases["split_bf16"])
        raise SystemExit(f"split_bf16 differs from its plain version: {cases['split_bf16']}")
    for name, keys, run, given, plain, yard, nbytes in (
            ("lut_matmul_t", ("dxs", "dx"),
             lambda i: lut_matmul_t(dy, packed, cb, nbits=nbits),
             lambda i: lut_matmul_t(dy, packed, cb, nbits=nbits, dy_split=dys),
             lambda i: lut_matmul_t_ref(dy, packed, cb, nbits=nbits),
             lambda i: torch.matmul(dy, w.T),
             m * n * 4 + k * n * nbits // 8 + 16 * 4 + m * k * 4),
            ("lut_codebook_grad", ("dcodebook", "dsmooth"),
             lambda i: lut_codebook_grad(x, dy, packed, cb, smooth, nbits=nbits),
             lambda i: lut_codebook_grad(x, dy, packed, cb, smooth, nbits=nbits, dy_split=dys),
             lambda i: lut_codebook_grad_ref(xs, dy, packed, cb, smooth, nbits=nbits),
             lambda i: torch.matmul(xs.T, dy),
             m * k * 4 + m * n * 4 + k * n * nbits // 8 + 16 * 4 + k * 4 + (16 + k) * 4)):
        t_ops, t_bytes = tc_ms * 1e-3, nbytes / HBM_BYTES_PER_S
        case = dict(kernel=name, m=m, k=k, n=n, nbits=nbits, dtype="float32",
                    errs={g: errs[g] for g in keys}, tols={g: tols[g] for g in keys},
                    max_abs_err=max(errs[g] for g in keys),
                    same_bits_twice=same[name],
                    ms=time_ms(run, 3), ms_given_split=time_ms(given, 3),
                    plain_ms=time_ms(plain, 2, warmup=1),
                    yardstick_ms=time_ms(yard, 3), library_ms=None,
                    bound_ms=max(t_ops, t_bytes) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    f32_core_bound_ms=f32_ms)
        if not (case["same_bits_twice"] and all(errs[g] <= tols[g] for g in keys)):
            emit("train_kernels", failed=case)
            raise SystemExit(f"backward kernel disagrees with its plain version: {case}")
        cases[name] = case
    return cases


def _check_train_kernels(gen) -> dict:
    """B2 and B4 at the student's forward shapes (M = batch x seq = 4096
    rows, f32 activations, 4-bit, float transform) against their plain
    versions (`_lut_check`, `_multi_check`), then timed (`_time_lut`,
    `_time_multi`) beside their bounds; the backward kernels at llama's
    projection shapes and BACKWARD_EXTRA's (`_backward_case`). Returns
    {kernel: [case, ...]}."""
    m = TRAIN_BATCH * TRAIN_SEQ
    out = {"lut_matmul_fused": [], "lut_matmul_fused_multi": [],
           **{name: [] for name in BACKWARD_KERNELS}}
    t0 = time.perf_counter()
    for mm, k, n, nbits in tuple((m, k, n, 4) for k, n in LLAMA_KN) + BACKWARD_EXTRA:
        for name, case in _backward_case(gen, mm, k, n, nbits).items():
            out[name].append(case)
    backward_s = time.perf_counter() - t0
    for k, n in LLAMA_KN:
        case, kern = _lut_check(gen, m, k, n, 4, torch.float32, False)
        case.update(_time_lut(gen, kern, m, k, n, 4, torch.float32, False))
        out["lut_matmul_fused"].append(case)
    for group in ("llama2-7b qkv", "llama2-7b gate_up"):
        k, widths = MULTI_GROUPS[group]
        p = len(widths)
        case, multi, solo = _multi_check(gen, group, m, k, widths, (4,) * p, (False,) * p,
                                         torch.float32)
        case.update(_time_multi(gen, multi, solo, m, k, widths, (4,) * p, (False,) * p,
                                torch.float32))
        out["lut_matmul_fused_multi"].append(case)
    # seconds of the backward kernels' cases, and of the whole check
    emit("train_kernels", cases=out, backward_s=round(backward_s, 2),
         seconds=round(time.perf_counter() - t0, 2))
    return out


def _fine_tune(model, teacher, student, data, held, loss_fn, paths, ce_before, fails):
    """(4b) FT_STEPS steps of `build_distill_step` (examples/distill_llm.py
    ft_step, its OptConfig, batches 1000 + step of the training data) on
    the student against the teacher: the forward through B2 / B4 at 4096
    rows, the backward through `lut_matmul_t` / `lut_codebook_grad`. Returns
    (the fine-tuned student, the run's launch counts, its report row);
    `ce_before` is the student's CE per held-out batch before it. Appends to
    `fails` what did not hold."""
    from repro_torch.core.api import _flatten_with_paths
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import build_distill_step
    from repro_torch.optim.optimizer import OptConfig, init_adam

    ft_cfg = OptConfig(lr=5e-4, warmup_steps=0, total_steps=FT_STEPS, weight_decay=0.0)
    step_fn = build_distill_step(model, teacher, ft_cfg)
    before = dict(_flatten_with_paths(student))
    opt = init_adam(student)
    kls, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for step in range(FT_STEPS):
        t0 = time.perf_counter()
        student, opt, kl = step_fn(student, opt, _on_card(data.batch(1000 + step)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        kls.append(float(kl))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del opt
    after = dict(_flatten_with_paths(student))

    def rel(field):
        return {p: float((getattr(after[p], field) - getattr(before[p], field)).norm()
                         / getattr(before[p], field).norm()) for p in paths}
    cb_change, smooth_change = rel("codebook"), rel("smooth")
    frozen = all(torch.equal(getattr(after[p], f), getattr(before[p], f))
                 for p in paths for f in ("inv_scale", "codes", "packed"))
    with torch.no_grad():
        ce_after = [float(loss_fn(student, b)) for b in held]
    first3, last3 = float(np.mean(kls[:3])), float(np.mean(kls[-3:]))
    cb_, ca_ = float(np.mean(ce_before)), float(np.mean(ce_after))
    out = dict(
        steps=FT_STEPS, lr=ft_cfg.lr, batch=TRAIN_BATCH, seq=TRAIN_SEQ, kl=kls,
        kl_first3_mean=first3, kl_last3_mean=last3, first_step_s=round(step_s[0], 4),
        s_per_step=round(float(np.mean(step_s[1:])), 4),
        peak_device_memory_gib=round(peak, 2),
        launches={n: c for n, c in counts.items() if c},
        codebook_rel_change=cb_change,
        codebook_rel_change_mean=float(np.mean(list(cb_change.values()))),
        smooth_rel_change_mean=float(np.mean(list(smooth_change.values()))),
        inv_scale_codes_packed_unchanged=frozen,
        ce_student_before=cb_, ppl_student_before=math.exp(cb_),
        ce_student_after=ca_, ppl_student_after=math.exp(ca_),
        ce_student_after_per_batch=ce_after)
    if not (all(np.isfinite(kls)) and last3 < first3):
        fails.append(f"the fine-tune's KL did not fall: {kls}")
    if not (all(v > 0 for v in cb_change.values()) and frozen):
        fails.append("the fine-tune did not move every codebook, or moved a frozen leaf")
    if not all(counts.get(n, 0) > 0 for n in BACKWARD_KERNELS + ("lut_matmul_fused",
                                                                 "lut_matmul_fused_multi")):
        fails.append(f"the fine-tune did not run B2 / B4 and both backward kernels: {counts}")
    return student, counts, out


def phase_train(seed: int):
    """The paper's pipeline on llama2-7b at full width (d_model 4096, d_ff
    11008, 32 heads, vocab 32000) cut to 4 layers, in float32, through the
    port's entry points: (1) `forward` = `decode_step` fed token by token
    (2e-3); (2) 30 steps of `build_train_step` at batch 8 x seq 512 on
    `SyntheticLM(seed)`, the loss falling; (3) on a `reduced()` llama2-7b a
    checkpoint saved, restored onto the card bit-equal, and 2 more steps
    from it equal to 2 from the live state; (4) `compress_model` under the
    empirical Fisher of `lm_loss` over `calibration_batches(n=2)` (the
    Fisher of FISHER_PATH held to a plain computation outside it), against
    the same call with H = 1, and CE / PPL of teacher and student on 4
    held-out batches, the student's forward through B2 / B4 at 4096 rows
    and its logits against the plain versions'; (4b) the codebook fine-tune
    of that student (`_fine_tune`); (5) an engine on the fine-tuned
    student: 4 staggered requests, tokens = each served alone. Returns the
    launch counts of (4)'s student evaluation, (4b)'s fine-tune and (5)'s
    drive, the `train_kernels` cases, (2)'s first TRAIN_MESH_STEPS steps
    (losses, gradient norms, seconds, a host copy of the params after them) for
    `train_mesh`'s 1 x 1 run, and (2)'s inputs and measurements (the bytes
    of a step's inputs, steady seconds a step, peak bytes) for `dryrun`."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import api
    from repro_torch.core.api import _flatten_with_paths, compress_model
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, calibration_batches
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.config import ShapeConfig, get_config, reduced
    from repro_torch.models.registry import get_model, lm_loss
    from repro_torch.optim.compress import EFState
    from repro_torch.optim.optimizer import OptConfig, init_adam
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=TRAIN_LAYERS, dtype="float32")
    model = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init(gen, device="cuda")
    row = dict(arch="llama2-7b", layers=TRAIN_LAYERS, d_model=cfg.d_model, d_ff=cfg.d_ff,
               n_heads=cfg.n_heads, vocab=cfg.vocab, dtype=cfg.dtype,
               params=model.param_count())
    fails = []

    # (1) forward = decode, position by position
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)).cuda()
    with torch.no_grad():
        full, _ = model.apply(params, {"tokens": tokens})
        cache = model.init_cache(2, 16, device="cuda")
        errs = []
        for i in range(8):
            lg, cache = model.decode(params, cache, {"tokens": tokens[:, i:i + 1],
                                                     "pos": cache["pos"]})
            errs.append(float((lg - full[:, i]).abs().max()))
    row["forward_vs_decode"] = dict(max_abs_err_per_position=errs, tol=2e-3)
    if not max(errs) <= 2e-3:
        fails.append("forward != decode_step")
    del full, cache

    # (2) training
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                                  seed=seed))
    opt_cfg = OptConfig(**TRAIN_OPT)
    with use_rules(make_host_mesh([torch.device("cuda", 0)])):
        step_fn = build_train_step(model, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                                   opt_cfg)
    opt, ef = init_adam(params), EFState(None)
    losses, gnorms, step_s = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_bytes = torch.cuda.memory_allocated()
    # what the process holds beyond the step's state (earlier phases'
    # tensors) is taken out of the drive's peak
    other = state_bytes - _storage_bytes(params, opt, ef)
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = _on_card(data.batch(step))
        if step == 0:                  # the step's inputs, for the dry run's check
            input_bytes = _storage_bytes(params, opt, ef, batch)
        params, opt, ef, metrics = step_fn(params, opt, ef, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if step == TRAIN_MESH_STEPS - 1:
            # train_mesh's 1 x 1 run: the same seed, data and OptConfig; its
            # params kept as a host copy, so the later steps' peak is what
            # it was without it
            one_by_one = dict(losses=list(losses), grad_norms=list(gnorms),
                              s_per_step=list(step_s),
                              params=[t.cpu() for t in leaves(params)],
                              peak_over_state_gib=round((torch.cuda.max_memory_allocated()
                                                         - state_bytes) / 2**30, 2))
    steady = float(np.mean(step_s[1:]))
    drive = dict(input_bytes=input_bytes, s_per_step=steady,
                 peak_bytes=torch.cuda.max_memory_allocated() - other)
    del batch
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    row["training"] = dict(
        steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=opt_cfg.lr,
        warmup_steps=opt_cfg.warmup_steps, first_step_s=round(step_s[0], 4),
        s_per_step=round(steady, 4), tokens_per_s=round(TRAIN_BATCH * TRAIN_SEQ / steady, 1),
        loss_step0=losses[0], loss_last=losses[-1], loss_first5_mean=first5,
        losses=[round(x, 4) for x in losses],
        loss_last5_mean=last5, grad_norm_step0=gnorms[0], grad_norm_last=gnorms[-1],
        peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    if not (last5 < first5 and all(np.isfinite(losses))):
        fails.append("training loss did not fall")
    teacher = params
    del opt, ef, metrics

    # (3) checkpoint on the card, reduced llama2-7b
    rcfg = reduced(get_config("llama2-7b"), dtype="float32")
    rmodel = get_model(rcfg)
    with use_rules(make_host_mesh([torch.device("cuda", 0)])):
        rstep = build_train_step(rmodel, ShapeConfig("train", 64, 4, "train"),
                                 OptConfig(lr=1e-3, warmup_steps=1, total_steps=5))
    rdata = SyntheticLM(DataConfig(vocab=rcfg.vocab, seq_len=64, batch_size=4, seed=seed))
    rp = rmodel.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    state = {"params": rp, "opt": init_adam(rp)}
    for s in range(3):
        p, o, _, _ = rstep(state["params"], state["opt"], EFState(None), _on_card(rdata.batch(s)))
        state = {"params": p, "opt": o}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        cm = CheckpointManager(ckdir)
        cm.save(3, state)
        step_r, restored = cm.restore_latest(state, device="cuda")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    same = [bool(a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b))
            for a, b in zip(leaves(restored), leaves(state))]
    cont = {}
    for name, st in (("live", state), ("restored", restored)):
        p, o, out = st["params"], st["opt"], []
        for s in (3, 4):
            p, o, _, m = rstep(p, o, EFState(None), _on_card(rdata.batch(s)))
            out.append(float(m["loss"]))
        cont[name] = out
    row["checkpoint"] = dict(arch=rcfg.arch_id, step=step_r, leaves=len(same),
                             leaves_equal=sum(same), losses_after=cont,
                             dir_removed=not os.path.exists(ckdir))
    if not (step_r == 3 and all(same) and cont["live"] == cont["restored"]
            and row["checkpoint"]["dir_removed"]):
        fails.append("checkpoint round trip or continuation differs")
    del state, restored, rp

    # (4) the paper's pipeline: compress under the empirical Fisher
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=seed)
    calib = [_on_card(b) for b in calibration_batches(dcfg, n=2)]

    def loss_fn(p, b):
        logits, _ = model.apply(p, b)
        return lm_loss(logits, b["targets"], b["loss_mask"], cfg.vocab)

    fisher_s, fisher_leaf = [], []
    inner = api._fisher

    def timed_fisher(*a, **kw):
        t = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        fisher_s.append(time.perf_counter() - t)
        fisher_leaf.append(out[FISHER_PATH].clone())
        return out

    api._fisher = timed_fisher
    try:
        t0 = time.perf_counter()
        student, rep = compress_model(teacher, loss_fn=loss_fn, calib_batches=calib,
                                      target_centroids=8, nbits=4)
        torch.cuda.synchronize()
        total_f = time.perf_counter() - t0
    finally:
        api._fisher = inner
    t0 = time.perf_counter()
    student_h1, _ = compress_model(teacher, target_centroids=8, nbits=4)
    torch.cuda.synchronize()
    total_h1 = time.perf_counter() - t0
    paths = sorted(rep.bits_assignment)
    err_f, err_h1 = _rel_errs(student, teacher, paths), _rel_errs(student_h1, teacher, paths)
    lf, lh = dict(_flatten_with_paths(student)), dict(_flatten_with_paths(student_h1))
    codes_differ = {p: int((lf[p].codes != lh[p].codes).sum()) for p in paths}
    del student_h1
    # the Fisher of one leaf, computed plainly: E[g^2] of that leaf's own
    # gradient, the rest of the teacher held fixed
    plain_f = torch.zeros_like(fisher_leaf[0])
    for b in calib:
        wq = teacher["blocks"]["attn"]["wq"].detach().requires_grad_(True)
        p_wq = {**teacher, "blocks": {**teacher["blocks"],
                                      "attn": {**teacher["blocks"]["attn"], "wq": wq}}}
        g, = torch.autograd.grad(loss_fn(p_wq, b), [wq])
        plain_f += g.float() ** 2
    plain_f /= len(calib)
    fisher_err = float((fisher_leaf[0] - plain_f).abs().max())
    fisher_check = dict(path=FISHER_PATH, max_abs_err=fisher_err,
                        max_fisher=float(plain_f.abs().max()), tol_rel_to_max=FISHER_TOL,
                        mean_fisher=float(plain_f.mean()))
    del calib, plain_f, fisher_leaf

    held = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                                  seed=4242))
    held = [_on_card(held.batch(i)) for i in range(4)]
    with torch.no_grad():
        ce_teacher = [float(loss_fn(teacher, b)) for b in held]
        torch.cuda.synchronize()
        reset_launch_counts()
        ce_student = [float(loss_fn(student, b)) for b in held]
        torch.cuda.synchronize()
        eval_counts = launch_counts()
        kern_logits, _ = model.apply(student, held[0])
        with _plain_versions():
            plain_logits, _ = model.apply(student, held[0])
            ce_plain = float(loss_fn(student, held[0]))
    diff = (kern_logits[..., :cfg.vocab] - plain_logits[..., :cfg.vocab]).abs()
    top2 = plain_logits[..., :cfg.vocab].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 0.12
    same_tok = kern_logits[..., :cfg.vocab].argmax(-1) == plain_logits[..., :cfg.vocab].argmax(-1)
    parity = dict(max_abs_logit_err=float(diff.max()), tol_max=STUDENT_TOL_MAX,
                  mean_abs_logit_err=float(diff.mean()), tol_mean=STUDENT_TOL_MEAN,
                  argmax_agreement=float(same_tok.float().mean()),
                  rows_with_clear_margin=int(clear.sum()),
                  logit_std=float(plain_logits[..., :cfg.vocab].std()),
                  ce_plain_batch0=ce_plain, ce_kernels_batch0=ce_student[0])
    del kern_logits, plain_logits, diff
    ct, cs = float(np.mean(ce_teacher)), float(np.mean(ce_student))
    mean_f = float(np.mean([e for v in err_f.values() for e in v]))
    row["pipeline"] = dict(
        target_centroids=8, nbits=4, calib_batches=2, fisher_s=round(sum(fisher_s), 3),
        distill_s=round(total_f - sum(fisher_s), 3), compress_total_s=round(total_f, 3),
        compress_h1_s=round(total_h1, 3), summary=rep.summary(),
        rel_weight_err_fisher=err_f, rel_weight_err_h1=err_h1,
        rel_weight_err_mean_fisher=mean_f, fisher_vs_plain=fisher_check,
        rel_weight_err_mean_h1=float(np.mean([e for v in err_h1.values() for e in v])),
        codes_differ_fisher_vs_h1=codes_differ,
        ce_teacher=ct, ppl_teacher=math.exp(ct), ce_student=cs, ppl_student=math.exp(cs),
        ce_teacher_per_batch=ce_teacher, ce_student_per_batch=ce_student,
        student_eval_launches={n: c for n, c in eval_counts.items() if c},
        student_kernels_vs_plain=parity)
    if not (len(fisher_s) == 1 and mean_f < 0.3 and any(codes_differ.values())
            and all(np.isfinite(ce_student)) and all(np.isfinite(ce_teacher))):
        fails.append("the Fisher pipeline's output is wrong")
    if not (fisher_check["max_fisher"] > 0
            and fisher_err <= FISHER_TOL * fisher_check["max_fisher"]):
        fails.append(f"the Fisher of {FISHER_PATH} differs from its plain computation")
    if not (parity["max_abs_logit_err"] <= STUDENT_TOL_MAX
            and parity["mean_abs_logit_err"] <= STUDENT_TOL_MEAN
            and bool(same_tok[clear].all())):
        fails.append("the student's kernels and plain versions disagree")
    if not (eval_counts["lut_matmul_fused"] > 0 and eval_counts["lut_matmul_fused_multi"] > 0):
        fails.append("the student's forward did not run B2 / B4")

    # (4b) the codebook fine-tune of the Fisher-compressed student
    student, ft_counts, row["fine_tune"] = _fine_tune(model, teacher, student, data, held,
                                                      loss_fn, paths, ce_student, fails)
    del teacher, held
    emit("train", **row)
    if fails:
        raise SystemExit(f"train: {'; '.join(fails)}")

    # (5) serve the fine-tuned student: 4 staggered requests, each = served alone
    serve_counts, _ = _serve("train_serve", "llama2-7b", seed, TRAIN_LAYERS, 4, 16, None,
                             solo_ids=(0, 1, 2, 3), params=student)
    counts = {n: eval_counts.get(n, 0) + ft_counts.get(n, 0) + serve_counts.get(n, 0)
              for n in set(eval_counts) | set(ft_counts) | set(serve_counts)}
    if not all(counts.get(n, 0) > 0 for n in TRAIN_PATH_KERNELS):
        raise SystemExit(f"train: a kernel of the path was never launched: {counts}")
    del student
    torch.cuda.empty_cache()
    return counts, _check_train_kernels(gen), one_by_one, drive


# ---------------------------------------------------------------------------
# training on (data, model) meshes of the card
# ---------------------------------------------------------------------------

TRAIN_MESH_STEPS = 3
# (data, model): the mesh shapes the train steps run on, each over [cuda:0] x n
TRAIN_MESHES = ((2, 1), (1, 2), (2, 2))
# per step, loss, gradient norm and aux against 1 x 1; the params after the
# last step (the reference's own microbatch test, tests/test_steps_system.py)
TRAIN_MESH_REL, TRAIN_MESH_RTOL, TRAIN_MESH_ATOL = 1e-4, 1e-3, 1e-5
# Adam's update g / (sqrt(v) + eps) is ill-conditioned on an element whose
# clipped gradient is non-zero and within K_EPS eps of zero at a step: an f32
# difference in it moves that step's update by a visible part of the step's
# lr, and Adam's moments carry it into the later steps
# (`tests/test_torch_train_mesh.py _ill_conditioned`, its first rule). Such
# elements, marked from the exact gradients the 1 x 1 step differentiated
# (`_recorded_grads`), may miss rtol / atol by 2 · lr_t for each step t from
# the first that marked them; a drive fails where more than LET_OFF_SHARE
# of its params need that (every other element is held to rtol / atol)
TRAIN_MESH_K_EPS = 100
TRAIN_MESH_LET_OFF_SHARE = 1e-6
# the elastic restarts: (model_parallel, devices) -> (n/mp, mp) then (n/2/mp, mp)
ELASTIC_RUNS = ((1, 4), (2, 4))
# every other family at full width in f32, (arch, layers): phi3.5-moe's one
# layer holds 5.0 GB of experts (Adam's moments, the gathered params and the
# gradients take a 1-layer step to ~38 GB), zamba2's 6 layers apply its
# shared attention block once (attn_period 6), whisper runs 2 encoder + 2
# decoder layers on 1500-frame inputs; TRAIN_MESH_STEPS steps on each of
# TRAIN_FAMILY_MESHES against 1 x 1
TRAIN_MESH_FAMILIES = (("phi3.5-moe-42b-a6.6b", 1), ("rwkv6-1.6b", 2), ("gla-1.3b", 2),
                       ("zamba2-1.2b", 6), ("whisper-large-v3", 2))
TRAIN_FAMILY_MESHES = ((2, 1), (1, 2))
# the family whose 1 x 1 and (1, 2) steps `_train_family` also traces
# (`_train_trace`): gla's mesh steps take 1.4-3.5x its 1 x 1 step
TRAIN_MESH_TRACED = "gla-1.3b"


@contextlib.contextmanager
def _recorded_grads(store):
    """While open, every gradient list the train step differentiates
    (`launch/steps.py _value_and_grads`, once a plain one-device step) is
    appended to `store` as the step returns it."""
    from repro_torch.launch import steps
    plain = steps._value_and_grads

    def recorded(loss_of, params):
        out = plain(loss_of, params)
        store.append(out[2])
        return out

    steps._value_and_grads = recorded
    try:
        yield
    finally:
        steps._value_and_grads = plain


def _train_one_by_one(model, opt_cfg, batches, seed, on_card=False, trace=False):
    """`TRAIN_MESH_STEPS` steps of the plain one-device train step from the
    seed's params (what `phase_train` records when it runs first): losses,
    gradient norms, auxes, seconds per step, peak memory over the state and
    the params after (a host copy, or on the card with `on_card`). With
    `on_card`, also `ill`: a uint8 a param leaf, bit t set on the elements
    Adam is ill-conditioned on at step t (TRAIN_MESH_K_EPS, from the step's
    own gradients, clipped as its Adam clips them, marked after the step's
    clock), and `lr`, each step's lr. With `trace`, one more step (its
    result dropped) under `_train_trace`."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.compress import EFState
    from repro_torch.optim.optimizer import global_norm, init_adam, lr_at
    from repro_torch.tree import leaves

    with use_rules(make_host_mesh([torch.device("cuda", 0)])):
        step_fn = build_train_step(model, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                                   opt_cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    opt, ef = init_adam(params), EFState(None)
    out = dict(losses=[], grad_norms=[], auxes=[], s_per_step=[])
    ill = [torch.zeros(t.shape, dtype=torch.uint8, device=t.device)
           for t in leaves(params)] if on_card else None
    grads = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_bytes = torch.cuda.memory_allocated()
    with _recorded_grads(grads) if on_card else contextlib.nullcontext():
        for t, b in enumerate(batches):
            t0 = time.perf_counter()
            params, opt, ef, m = step_fn(params, opt, ef, b)
            torch.cuda.synchronize()
            out["s_per_step"].append(time.perf_counter() - t0)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            out["auxes"].append(float(m["aux"]))
            if grads:
                g = grads.pop()
                scale = min(1.0, opt_cfg.clip_norm / max(float(global_norm(g)), 1e-12))
                for mask, x in zip(ill, g):
                    a = (x.to(torch.float32) * scale).abs()
                    mask |= ((a > 0) & (a < TRAIN_MESH_K_EPS * opt_cfg.eps)).to(torch.uint8) << t
                del g, a
    out["peak_over_state_gib"] = round(
        (torch.cuda.max_memory_allocated() - state_bytes) / 2**30, 2)
    if trace:
        out["trace"] = _train_trace(lambda: step_fn(params, opt, ef, batches[0]),
                                    float(np.mean(out["s_per_step"][1:])))
    del opt, ef, m
    out["params"] = leaves(params) if on_card else [t.cpu() for t in leaves(params)]
    if on_card:
        out["ill"] = ill
        out["lr"] = [float(lr_at(opt_cfg, torch.tensor(t + 1))) for t in range(len(batches))]
    return out


def _rank_bytes(tree):
    """{"d<i>m<j>": bytes} of the tensors data rank i's model rank j holds."""
    from repro_torch.tree import leaves
    n_data, n_model = len(tree.views), tree.mesh.shape.get("model", 1)
    return {f"d{d}m{m}": sum(t.numel() * t.element_size()
                             for t in leaves(tree.rank_tree(model_rank=m, data_rank=d)))
            for d in range(n_data) for m in range(n_model)}


def _train_on_mesh(model, opt_cfg, batches, seed, ms, one_by_one, want_params, fails,
                   label, ill=None, lrs=(), trace=False) -> dict:
    """TRAIN_MESH_STEPS steps on the (data, model) mesh `ms` of the card from
    the seed's params, through `build_train_step` under `use_rules(mesh)`,
    `place_train_state` and the bundle, against the 1 x 1 run `one_by_one`:
    per step loss, gradient norm and aux within TRAIN_MESH_REL, the params
    after the last step (`MeshTree.whole`) against `want_params` within
    TRAIN_MESH_RTOL / ATOL but the elements `ill` marks (the 1 x 1 run's
    ill-conditioned ones, TRAIN_MESH_K_EPS), held to 2 · lrs[t] more for
    each step t from the first that marked them, no more than
    TRAIN_MESH_LET_OFF_SHARE of the params let off so, the distinct tensors
    of the placed state holding exactly the whole state's bytes; a miss is
    appended to `fails`. Returns the mesh's row: the numbers, the elements
    let off, seconds per step (host clock after a synchronize), peak device
    memory over the state, the bytes each rank holds, and with `trace` one
    more step (its result dropped) under `_train_trace`."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.steps import build_train_step, place_train_state
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.optimizer import init_adam
    from repro_torch.tree import flatten_with_paths, leaves

    mesh = _mesh_of(ms)
    with use_rules(mesh):
        bundle = build_train_step(model, ShapeConfig("train_mesh", TRAIN_SEQ, TRAIN_BATCH,
                                                     "train"), opt_cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    opt = init_adam(params)
    whole_bytes = sum(t.numel() * t.element_size() for t in leaves(params) + leaves(opt))
    p, o, e = place_train_state(bundle, mesh, params, opt)
    del params, opt
    distinct_bytes = sum(t.numel() * t.element_size() for t in p.parts() + o.parts())
    rank_bytes = _rank_bytes(p)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state_bytes = torch.cuda.memory_allocated()
    losses, gnorms, auxes, secs = [], [], [], []
    for b in batches:
        t0 = time.perf_counter()
        p, o, e, m = bundle(p, o, e, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        auxes.append(float(m["aux"]))
    peak = torch.cuda.max_memory_allocated() - state_bytes
    traced = (_train_trace(lambda: bundle(p, o, e, batches[0]), float(np.mean(secs[1:])))
              if trace else None)
    del o, e, m
    worst, worst_leaf, params_close, let_off, n_elements = 0.0, None, True, 0, 0
    # a marked element's slack: 2 · lr_t for every step t from its first mark on
    after = [2 * sum(lrs[t:]) for t in range(len(lrs))]
    for i, ((path, got), want) in enumerate(zip(flatten_with_paths(p.whole()), want_params)):
        n_elements += want.numel()
        tol = TRAIN_MESH_ATOL + TRAIN_MESH_RTOL * want.abs()
        err = (got - want).abs() / tol
        off = err > 1
        if ill is not None and bool(off.any()):
            bits = ill[i][off]
            slack = torch.zeros(bits.shape, dtype=torch.float32, device=bits.device)
            for t in reversed(range(len(lrs))):
                slack = torch.where((bits >> t) & 1 == 1, after[t], slack)
            marked = bits != 0
            params_close &= bool(((got - want).abs()[off] <= tol[off] + slack)[marked].all())
            let_off += int(marked.sum())
            err[off] = torch.where(marked, torch.zeros_like(err[off]), err[off])
            off = err > 1
        params_close &= not bool(off.any())
        if float(err.max()) > worst:
            worst, worst_leaf = float(err.max()), path
    del p
    let_off_ok = let_off <= TRAIN_MESH_LET_OFF_SHARE * n_elements
    rel = [max(abs(a - b) / abs(b) for a, b in zip(got, want) if b) for got, want in (
        (losses, one_by_one["losses"]), (gnorms, one_by_one["grad_norms"]))]
    aux_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
        auxes, one_by_one.get("auxes", [0.0] * len(auxes))))
    row = dict(losses=losses, grad_norms=gnorms, auxes=auxes,
               max_rel_err_loss_gnorm=max(rel), max_rel_err_aux=aux_rel,
               params_worst_err_over_tol=worst, params_worst_leaf=worst_leaf,
               params_close=params_close, ill_conditioned_let_off=let_off,
               let_off_share=let_off / n_elements, trace=traced,
               s_per_step=[round(x, 4) for x in secs],
               s_per_step_steady=round(float(np.mean(secs[1:])), 4),
               peak_over_state_gib=round(peak / 2**30, 2),
               state_bytes_whole=whole_bytes, state_bytes_distinct=distinct_bytes,
               param_bytes_per_rank=rank_bytes)
    if not (max(rel) <= TRAIN_MESH_REL and aux_rel <= TRAIN_MESH_REL and params_close
            and let_off_ok and distinct_bytes == whole_bytes and all(np.isfinite(losses))):
        fails.append(f"{label} {ms[0]}x{ms[1]}: {row}")
    torch.cuda.empty_cache()
    return row


def _elastic_run(seed, mp, n, fails) -> dict:
    """`simulate_failure_and_resume` of a reduced llama2-7b (f32) over
    [cuda:0] x n at model_parallel mp, its checkpoint under build/ (removed
    after)."""
    import shutil
    import tempfile

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.elastic import simulate_failure_and_resume
    from repro_torch.models.config import get_config, reduced
    from repro_torch.models.registry import get_model

    model = get_model(reduced(get_config("llama2-7b"), dtype="float32"))
    data = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq_len=64, batch_size=8, seed=seed))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_elastic_", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    try:
        rep = simulate_failure_and_resume(model, ckdir, data_fn=lambda s: _on_card(data.batch(s)),
                                          steps_each=5, devices=[torch.device("cuda", 0)] * n,
                                          model_parallel=mp)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    row = dict(arch=model.cfg.arch_id, mesh_before=rep.mesh_before, mesh_after=rep.mesh_after,
               resumed_step=rep.resumed_step, loss_before=rep.loss_before,
               loss_after=rep.loss_after, restored_equal=rep.restored_equal,
               seconds=round(time.perf_counter() - t0, 2),
               dir_removed=not os.path.exists(ckdir))
    if not (rep.resumed_step == 5 and rep.restored_equal and np.isfinite(rep.loss_after)
            and rep.loss_after < rep.loss_before + 0.5 and row["dir_removed"]):
        fails.append(f"elastic resume {rep.mesh_before} -> {rep.mesh_after}: {row}")
    return row


def _train_family(arch, layers, seed, fails) -> dict:
    """One family's drive of `train_mesh`: `arch` at full width cut to
    `layers` (whisper: that many encoder and decoder layers) in f32,
    `train`'s batches (8 x 512 from `SyntheticLM(seed)`; whisper's frames
    (8, 1500, 1280) from the seed, the shape `input_specs` gives its train
    step), TRAIN_MESH_STEPS steps at 1 x 1 and on each of
    TRAIN_FAMILY_MESHES (`_train_on_mesh`). An MoE step routes each step's
    whole token set once (one graph over the data ranks); a recurrent
    mixer runs once per model rank over its heads."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.config import ShapeConfig, get_config, input_specs
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import OptConfig

    t0 = time.perf_counter()
    cut = dict(n_layers=layers, dtype="float32")
    if get_config(arch).n_enc_layers:
        cut["n_enc_layers"] = layers
    cfg = dataclasses.replace(get_config(arch), **cut)
    model = get_model(cfg)
    opt_cfg = OptConfig(**TRAIN_OPT)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                                  seed=seed))
    specs = input_specs(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    gen = np.random.default_rng(seed + 17)
    batches = []
    for s in range(TRAIN_MESH_STEPS):
        b = _on_card(data.batch(s))
        if "frames" in specs:
            b["frames"] = torch.from_numpy(gen.standard_normal(
                tuple(specs["frames"].shape), dtype=np.float32)).cuda()
        batches.append(b)
    trace = arch == TRAIN_MESH_TRACED
    one = _train_one_by_one(model, opt_cfg, batches, seed, on_card=True, trace=trace)
    want_params, ill, lrs = one.pop("params"), one.pop("ill"), one.pop("lr")
    n = sum(t.numel() for t in want_params)
    one["marked"] = sum(int((m != 0).sum()) for m in ill)
    one["marked_share"] = one["marked"] / n
    torch.cuda.empty_cache()
    meshes = {f"{ms[0]}x{ms[1]}": _train_on_mesh(model, opt_cfg, batches, seed, ms, one,
                                                want_params, fails, arch, ill, lrs,
                                                trace and ms == (1, 2))
              for ms in TRAIN_FAMILY_MESHES}
    del want_params, ill, batches
    torch.cuda.empty_cache()
    return dict(layers=layers, enc_layers=cut.get("n_enc_layers"),
                params=model.param_count(), n_experts=cfg.n_experts,
                one_by_one=dict(**one, s_per_step_steady=round(float(np.mean(
                    one["s_per_step"][1:])), 4)),
                meshes=meshes, seconds=round(time.perf_counter() - t0, 2))


def phase_train_mesh(seed: int, one_by_one=None) -> dict:
    """Training on (data, model) meshes of the card, through the entry points
    a user calls (`build_train_step` under `use_rules(mesh)`,
    `place_train_state`, the bundle, `MeshTree.whole`): llama2-7b at full
    width cut to TRAIN_LAYERS in f32, `train`'s batches (8 x 512 from
    `SyntheticLM(seed)`) and OptConfig, TRAIN_MESH_STEPS steps on each of
    TRAIN_MESHES from the seed's params, against the same steps at 1 x 1
    (`one_by_one`, the first steps of `phase_train`, or run here): per step
    loss and gradient norm within 1e-4 relative, the params after the last
    step within rtol 1e-3 / atol 1e-5, the distinct tensors of the placed
    state holding exactly the whole state's bytes (`_train_on_mesh`).
    Prints seconds per step (host clock after a synchronize), peak device
    memory over the state beside 1 x 1's and the bytes each rank holds.
    Then the elastic restart (`launch/elastic.py
    simulate_failure_and_resume`) of a reduced llama2-7b over [cuda:0] x 4
    at (4, 1) -> (2, 1) and (2, 2) -> (1, 2): resumed at the checkpoint's
    step, every restored leaf torch.equal to the saved one, the loss after
    within 0.5 of the loss before. Then every other family
    (TRAIN_MESH_FAMILIES, `_train_family`): the same checks on (2, 1) and
    (1, 2) against its own 1 x 1 run, the MoE aux too. Mesh training runs
    on dense weights and launches none of the hand-written kernels (neither
    package's training forward calls B9); the count is printed."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.config import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import OptConfig

    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=TRAIN_LAYERS, dtype="float32")
    model = get_model(cfg)
    opt_cfg = OptConfig(**TRAIN_OPT)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                                  seed=seed))
    batches = [_on_card(data.batch(s)) for s in range(TRAIN_MESH_STEPS)]
    ran_one_by_one = one_by_one is None
    if ran_one_by_one:
        one_by_one = _train_one_by_one(model, opt_cfg, batches, seed)
    want_params = [t.cuda() for t in one_by_one.pop("params")]
    fails = []
    reset_launch_counts()
    meshes = {f"{ms[0]}x{ms[1]}": _train_on_mesh(model, opt_cfg, batches, seed, ms, one_by_one,
                                                want_params, fails, "llama2-7b")
              for ms in TRAIN_MESHES}
    del want_params, batches
    torch.cuda.empty_cache()
    elastic = [_elastic_run(seed, mp, n, fails) for mp, n in ELASTIC_RUNS]
    families = {arch: _train_family(arch, layers, seed, fails)
                for arch, layers in TRAIN_MESH_FAMILIES}
    counts = {n: c for n, c in launch_counts().items() if c}
    emit("train_mesh", arch="llama2-7b", layers=TRAIN_LAYERS, dtype=cfg.dtype,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_MESH_STEPS,
         one_by_one=dict(**one_by_one, from_phase_train=not ran_one_by_one,
                         s_per_step_steady=round(float(np.mean(
                             one_by_one["s_per_step"][1:])), 4)),
         meshes=meshes, elastic=elastic, families=families, kernel_launches=counts,
         tol=dict(loss_gnorm_aux_rel=TRAIN_MESH_REL, params_rtol=TRAIN_MESH_RTOL,
                  params_atol=TRAIN_MESH_ATOL))
    if fails:
        raise SystemExit(f"train_mesh: {'; '.join(fails)}")
    return counts


# ---------------------------------------------------------------------------
# the mixture-of-experts family
# ---------------------------------------------------------------------------

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
# the MoE block alone against its own plain-f32 run: bf16 weights, products
# and activations against f32 ones on the same routing
MOE_BLOCK_TOL_REL = 3e-2
MOE_RANGES = ("moe.resolve_weight", "moe.expert_matmul", "moe.routing",
              "moe.dispatch_combine")


def _moe_block_alone(model, params, seed) -> dict:
    """Layer 0's MoE block of `params` alone at the card's decode (8 x 1
    tokens) and prefill (8 x 32) widths: the bf16 block against the same
    block run in f32 (`resolve_weight` in f32, f32 products) on the same
    inputs. The routing reads the same f32 router logits, so the drops and
    the aux loss must be equal; the outputs within MOE_BLOCK_TOL_REL of the
    f32 output's largest value. Then the device ms of the block, of
    resolving one expert weight (against its bound: the packed codes read
    and the bf16 weight written once) and of the whole-stack route it
    replaces."""
    import dataclasses

    from repro_torch.core.api import _unpack_codes
    from repro_torch.models import layers
    from repro_torch.models.transformer import layer_slice

    cfg = model.cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = layer_slice(params["blocks"], 0)["mlp"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    out, fails = {}, []
    for name, (s, t) in (("decode", (8, 1)), ("prefill", (8, 32))):
        x = torch.randn((s, t, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            y, aux = layers.moe_block(p, x, cfg)
            y32, aux32 = layers.moe_block(p, x.float(), cfg32)
            g, sg = layers.moe_groups(s * t)
            r = layers.moe_routing(p["router"], x.reshape(g, sg, -1), cfg.n_experts,
                                   cfg.moe_topk)
            r32 = layers.moe_routing(p["router"], x.float().reshape(g, sg, -1),
                                     cfg.n_experts, cfg.moe_topk)
        drops = s * t * cfg.moe_topk - int(r.dispatch.sum())
        same_routing = (torch.equal(r.dispatch, r32.dispatch)
                        and torch.equal(r.combine, r32.combine))
        err = float((y.float() - y32).abs().max())
        scale = float(y32.abs().max())
        row = dict(tokens=s * t, groups=g, group_size=sg, capacity=r.cap,
                   topk=cfg.moe_topk, experts=cfg.n_experts, dropped_token_slots=drops,
                   of_token_slots=s * t * cfg.moe_topk, same_routing_as_f32=same_routing,
                   aux_equal=bool(torch.equal(aux, aux32)), max_abs_err=err,
                   f32_abs_max=scale, tol=MOE_BLOCK_TOL_REL * scale,
                   mean_abs_err=float((y.float() - y32).abs().mean()))
        with torch.no_grad():
            row["block_ms"] = round(time_ms(lambda i: layers.moe_block(p, x, cfg), 3), 4)
        if not (same_routing and row["aux_equal"] and bool(torch.isfinite(y.float()).all())
                and err <= MOE_BLOCK_TOL_REL * scale):
            fails.append(name)
        out[name] = row
    w = p["w_gate"]
    n_el = w.smooth.shape[0] * w.smooth.shape[1] * w.codes.shape[-1]
    bound = (w.codes.numel() + 2 * n_el) / HBM_BYTES_PER_S * 1e3
    whole = torch.empty((n_el,), dtype=torch.bfloat16, device="cuda")

    def whole_stack(i):
        # the route per expert replaces: int64 indices over the whole stack
        codes = _unpack_codes(w.codes, w.smooth.shape[-1], w.nbits).long()
        dense = torch.stack([cb[cd] for cb, cd in zip(w.codebook, codes)])
        whole.copy_((dense / w.smooth[..., :, None]).view(-1))
    with torch.no_grad():
        per_expert = layers.resolve_weight(w, torch.bfloat16)
        whole_stack(0)
        equal = bool(torch.equal(per_expert.view(-1), whole))
        del per_expert
        out["resolve_weight_one_expert_weight"] = dict(
            shape=[w.smooth.shape[0], w.smooth.shape[1], w.codes.shape[-1]], nbits=w.nbits,
            ms=round(time_ms(lambda i: layers.resolve_weight(w, torch.bfloat16), 3), 4),
            whole_stack_ms=round(time_ms(whole_stack, 2), 4), bound_ms=round(bound, 4),
            bound_by="bytes", per_expert_equals_whole_stack=equal)
    del whole
    if not equal:
        fails.append("resolve_weight per expert != whole stack")
    return out, fails


def phase_moe_parity(seed: int) -> dict:
    """phi3.5-moe-42b-a6.6b at full width, 2 layers, LCD 4-bit with the
    stacked experts clustered too (`materialize_clustered`): the same params
    and steps (one prefill chunk, two decode steps, an idle slot) through
    the kernels and through their plain versions (`_plain_versions`), both
    on the card: in f32 with the float transform at `model_parity`'s tight
    limits, and in bf16 with the quantized transform at limits of its own
    (see `variants`) and argmax where the plain side's margin is clear. The MoE block itself has no kernel:
    both sides run it alike, and its routing sees what the kernels gave
    it. Then the block alone (`_moe_block_alone`), and B1-B5 at both MoE
    archs' attention shapes against their plain versions, timed
    (`kernels_moe` line). Returns the kernel sides' launch counts."""
    import dataclasses

    from repro_torch.core.clustered_params import materialize_clustered
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.config import get_config
    from repro_torch.models.registry import get_model

    arch = MOE_ARCHS[0]
    s, t, nbw, nb, bs = 8, 32, 8, 64, 16
    rng = np.random.default_rng(seed)
    tables = rng.permutation(nb)[:s * nbw].reshape(s, nbw).astype(np.int32)
    n_first = rng.integers(5, t + 1, s).astype(np.int32)
    n_first[3] = 0                                         # an idle slot
    active = n_first > 0
    vocab = get_config(arch).vocab
    steps = [(rng.integers(0, vocab, (s, t)).astype(np.int32), n_first)]
    for _ in range(2):
        steps.append((rng.integers(0, vocab, (s, 1)).astype(np.int32),
                      active.astype(np.int32)))
    # (dtype, quantized transform, layers, max |dlogit| allowed, mean allowed).
    # f32: model_parity's limits. bf16: this model's own, about 3x its
    # readings on the H100 (max 0.03125, one bf16 ulp at its largest logits,
    # about 5.8; mean 0.00187; the same in three runs). model_parity's
    # 0.75 / 0.03 fit its llama2-7b model, which reads 0.367 / 0.0126.
    variants = (("float32", False, 2, 1e-3, 1e-4), ("bfloat16", True, 2, 0.1, 0.006))
    clear_margin = 0.12
    report, counts, block = [], {}, None
    for dtype, quantized, n_layers, tol_max, tol_mean in variants:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype=dtype)
        model = get_model(cfg)
        p = materialize_clustered(model, torch.Generator(device="cuda").manual_seed(seed),
                                  nbits=4, device="cuda")
        if quantized:
            p = calibrate(p)
        logits = {}
        for side in ("kernels", "plain"):
            caches = model.init_seq_caches(num_blocks=nb, block_size=bs, num_slots=s,
                                           max_seq=nbw * bs, kv_dtype="float", device="cuda")
            lengths = np.zeros(s, np.int32)
            outs = []
            torch.cuda.synchronize()
            reset_launch_counts()
            for tokens, n_new in steps:
                args = [torch.from_numpy(a).cuda() for a in (tokens, lengths, n_new, tables)]
                if side == "plain":
                    with _plain_versions():
                        lg, caches = model.serving_step(p, caches, *args)
                else:
                    with _no_host_sync():
                        lg, caches = model.serving_step(p, caches, *args)
                outs.append(lg[active][:, :vocab].float().cpu())
                lengths = lengths + n_new
            if side == "kernels":
                for n, c in launch_counts().items():
                    counts[n] = counts.get(n, 0) + c
            logits[side] = torch.stack(outs)
            del caches
        report.append(_parity_row(logits, tol_max, tol_mean, clear_margin, dtype=dtype,
                                  quantized_transform=quantized, layers=n_layers))
        if dtype == "bfloat16":
            block = _moe_block_alone(model, p, seed)
        del p
        torch.cuda.empty_cache()
    block, block_fails = block
    emit("moe_parity", arch=arch, steps=len(steps), experts_clustered=True, variants=report,
         moe_block_alone=block, launches=counts)
    if not all(r["ok"] for r in report) or block_fails:
        raise SystemExit(f"moe_parity: the kernels' and the plain versions' logits disagree, "
                         f"or the MoE block alone is wrong ({block_fails}): {report}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    cases, worst = check_family_kernels(gen, archs=MOE_ARCHS, rows=(8, 256))
    emit("kernels_moe", cases=cases, worst=worst)
    return counts


def _step_breakdown(engine, width, n_steps, ranges=None, phase="serve_moe"):
    """Device ms per step of `engine` at `width` with all 8 slots busy, under
    torch.profiler: through the step's graph (kernels by name: the LUT
    kernels, B5, everything) and through the eager body, where the model's
    profiler ranges (`ranges`: the MoE block's `MOE_RANGES` by default)
    split its time."""
    ranges = MOE_RANGES if ranges is None else ranges
    from torch.profiler import ProfilerActivity, profile, schedule

    def run(eager):
        rows = {}

        def add(key, us, per=1e3):
            rows[key] = rows.get(key, 0.0) + us / per / n_steps

        def read(prof):
            # a range's device time: the kernels launched inside it (its CPU
            # event's kernels and its children's); the profiler mirrors each
            # range, and each step, as a device-side annotation, which is no
            # kernel and is left out of the sums by kind
            for ev in prof.events():
                if ev.name in ranges and ev.device_type == torch.autograd.DeviceType.CPU:
                    add(ev.name, ev.device_time_total)
            for ev in prof.key_averages():
                if (ev.device_type != torch.autograd.DeviceType.CUDA or ev.key in ranges
                        or ev.key.startswith("ProfilerStep")):
                    continue
                dev = getattr(ev, "self_device_time_total", None)
                if dev is None:
                    dev = ev.self_cuda_time_total
                if dev > 0:
                    add("lut_kernels" if "lut_" in ev.key else
                        "attention_b5" if "paged_attn" in ev.key else "other", dev)
                    add("device_busy", dev)
                    add("kernels", ev.count, per=1)
        ran = engine.traces.get(width, 0)
        with _eager_body(engine, eager):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=n_steps, repeat=1),
                         on_trace_ready=read) as prof:
                for _ in range(n_steps + 1):
                    engine.step()
                    prof.step()
        if engine.traces.get(width, 0) - ran != n_steps + 1 or any(
                r is None for r in engine.slots):
            raise SystemExit(f"{phase}: the profiled steps were not all of width {width} "
                             f"with 8 slots busy")
        return {k: round(v, 3) for k, v in rows.items()}
    graph, eager = run(False), run(True)
    wall, span = _wall_ms_per_step(engine, n_steps)
    return dict(graph=graph, eager=eager, graph_wall_ms_per_step=round(wall, 3),
                graph_event_span_ms_per_step=round(span, 3))


def _moe_step_profile(arch, params, n_layers, seed) -> dict:
    """A prefill-width step and a decode step of an engine on `params` with
    all 8 slots busy (8 prompts of 192 tokens): `_step_breakdown` of each,
    the captures' seconds and the peak device memory since the engine was
    built (the graph pool holds one transient per step shape)."""
    from repro_torch.launch.engine import EngineConfig, build_engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ecfg = EngineConfig(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=256,
                        max_blocks_per_slot=32)
    engine, _ = build_engine(arch, use_reduced=False, lcd=True, ecfg=ecfg, seed=seed,
                             params=params, n_layers=n_layers, device="cuda")
    rng = np.random.default_rng(seed + 13)
    # 6 prefill-width steps (192 / 32) and 10 decode steps: a warm-up each,
    # then 2 + 2 + 1 (graph, eager, wall) prefill and 3 + 3 + 2 decode steps
    for _ in range(8):
        engine.submit(rng.integers(0, engine.model.cfg.vocab, 192).astype(np.int32),
                      max_new_tokens=11)
    engine.step()                                   # the prefill width's warm-up, capture
    out = {"prefill_width_32": _step_breakdown(engine, 32, 1)}
    while any(r is not None and r.prefilling for r in engine.slots):
        engine.step()
    engine.step()                                   # the decode width's warm-up, capture
    out["decode_width_1"] = _step_breakdown(engine, 1, 2)
    out["graph_capture_s"] = {str(w): round(c, 3)
                              for w, c in engine._graphs.capture_seconds().items()}
    engine.run()
    torch.cuda.synchronize()
    out["peak_over_params_gib"] = round((torch.cuda.max_memory_allocated() - base) / 2**30, 2)
    out["peak_device_memory_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
    del engine
    return out


def _serve_spec_moe(arch, seed, params, n_layers=2, k=SPEC_K, new_tokens=16):
    """Speculative self-drafting on an MoE model cut to `n_layers`: its
    2-bit draft made on the card (the attention re-clustered; the experts,
    which `compress_model`'s default predicate does not take, dequantized
    and kept dense, as in the JAX package), the speculative engine (k = 3)
    over 8 staggered requests: launch counts per role, bounded shapes, the
    mean accepted length, then every replay of the three graphs against
    their eager bodies (`_graph_check`). Spec = plain greedy, engine = solo
    and verify rows = width-1 rows are not asserted: an MoE layer routes
    every row of a step together under a capacity, so a token's output
    depends on what shares its step (the JAX package bounds its own forward
    against decode by 1.0 for MoE); the port is held to the JAX package's
    engine in lockstep on the CPU instead (tests/test_torch_moe_engine.py).
    Returns the drive's launches."""
    from repro_torch.core.clustered_params import make_draft_params
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.engine import EngineConfig, build_engine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draft, report = make_draft_params(params, draft_centroids=4)
    torch.cuda.synchronize()
    draft_s = time.perf_counter() - t0
    base = dict(num_slots=8, block_size=16, prefill_chunk=32, num_blocks=256,
                max_blocks_per_slot=32)
    spec, _ = build_engine(arch, use_reduced=False, lcd=True, n_layers=n_layers,
                           ecfg=EngineConfig(speculative_k=k, **base), params=params,
                           draft_params=draft, device="cuda")
    cfg = spec.model.cfg
    prompts = _serve_prompts(cfg.vocab, seed, 8)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = [list(r.out_tokens) for r in _drive(spec, prompts, new_tokens)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, traces = launch_counts(), dict(spec.traces)
    spec.assert_bounded_traces()
    expected = _spec_expected_launches(n_layers, traces, k, "moe")
    ok = (all(len(t) == new_tokens for t in got)
          and all(0 <= tok < cfg.vocab for t in got for tok in t) and counts == expected
          and set(traces) == {("prefill", 32), ("draft", k), ("verify", k + 1)}
          and all(counts[n] > 0 for n in expected if n not in NOT_SERVING))
    emit("serve_moe_spec", arch=arch, layers=n_layers, speculative_k=k,
         requests=len(prompts), new_tokens_each=new_tokens,
         tokens_per_s=round(sum(map(len, got)) / wall, 2),
         acceptance_summary=spec.acceptance_summary(),
         traces={str(key): c for key, c in traces.items()}, launches=counts,
         launches_expected=expected,
         draft=dict(make_draft_params_s=round(draft_s, 2), summary=report.summary()),
         peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    if not ok:
        raise SystemExit(f"serve_moe_spec: {arch}: tokens, launch counts or shapes are wrong: "
                         f"traces={traces} {counts} vs {expected}")
    _graph_check("serve_moe_spec", spec, seed)
    del spec, draft
    return counts


# the MoE family at full width: phi3.5-moe cut to 1 of its 32 layers (32 -> 16
# when the audio phases came, 16 -> 8 for serve_mesh, 8 -> 4 for train_mesh,
# 4 -> 2 for train_mesh's other families, 2 -> 1 for the dry run: the cut the
# script's time limit asks for first), llama4-scout cut to 1 (its 48 would
# need ~54 GB of packed experts; at 8 layers the script ran 771 s, run 24b,
# and a decode step resolves 2 B expert weights a layer; 4 -> 2 -> 1 with
# phi3.5-moe)
MOE_DEPTHS = (("phi3.5-moe-42b-a6.6b", 1), ("llama4-scout-17b-a16e", 1))


def phase_serve_moe(seed: int) -> dict:
    """The MoE family served like `serve`: LCD 4-bit weights from the seed
    with the stacked experts clustered too (`materialize_clustered`) and the
    quantized transform armed, fused projections, the `serve` engine's
    geometry and 12 requests, over the float pool: phi3.5-moe-42b-a6.6b and
    llama4-scout-17b-a16e cut to 1 layer (`MOE_DEPTHS`), at full width. Launch
    counts per model step (an MoE layer's LUT launches are its attention's),
    bounded shapes, every replay equal to its eager body in tokens and pools
    (`_graph_check`), tokens/s, and the step times with 8 slots busy and
    where their device time goes (`_moe_step_profile`). Then on phi3.5-moe's
    layers an int8 pool and speculation (k = 3, `_serve_spec_moe`).

    Engine = solo, spec = plain greedy, verify rows = width-1 rows and
    `_row_count_ops` are not asserted here, unlike for every dense arch: an
    MoE layer routes every token of a step together (idle slots' pad tokens
    included) and drops tokens past an expert's capacity, so a request's
    tokens depend on what shares its steps, in the JAX package too; the port
    is held to the JAX package's engine in lockstep under the same schedule
    on the CPU (tests/test_torch_moe_engine.py). Returns the launches of
    the full-width drives, summed."""
    total = {}

    def add(counts):
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c

    for arch, layers in MOE_DEPTHS:
        t0 = time.perf_counter()
        _, params = _served_params(arch, seed, layers)
        counts, _ = _serve("serve_moe", arch, seed, layers, 12, 24, None, solo_ids=(),
                           params=params)
        add(counts)
        prof = _moe_step_profile(arch, params, layers, seed)
        emit("serve_moe_profile", arch=arch, layers=layers, **prof)
        if arch == MOE_ARCHS[0]:
            # copies of the layers, so that the full drive's storage goes
            kept = _first_layers(params, layers)
            kept["blocks"] = _cloned(kept["blocks"])
            del params
            torch.cuda.empty_cache()
            add(_serve("serve_moe_int8", arch, seed, layers, 4, 24, "int8", solo_ids=(),
                       params=kept)[0])
            add(_serve_spec_moe(arch, seed, kept, n_layers=layers))
            del kept
        else:
            del params
        torch.cuda.empty_cache()
        emit("serve_moe_arch", arch=arch, layers=layers,
             seconds=round(time.perf_counter() - t0, 1),
             peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    return total


# ---------------------------------------------------------------------------
# the recurrent and hybrid families
# ---------------------------------------------------------------------------

RECURRENT_FAMILIES = ("rwkv", "linear_attn", "hybrid")
# at full width and full depth
RECURRENT_DEPTHS = (("rwkv6-1.6b", 24), ("gla-1.3b", 24), ("zamba2-1.2b", 38))
# what a step of each family launches: rwkv6's and gla's projections are
# solo GEMVs (8 slots a token); zamba2's shared block adds B3 and B5
RECURRENT_PATH = {"rwkv": ("lut_matmul_fused_gemv",),
                  "linear_attn": ("lut_matmul_fused_gemv",),
                  "hybrid": ("lut_matmul_fused_gemv", "lut_matmul_fused_multi_gemv",
                             "paged_pool_attention")}
# the eager body's profiler ranges of a recurrent step: the recurrence's
# token steps and the in-place masked state update
RECURRENT_RANGES = ("recurrent.scan", "recurrent.mask_state")


def _recurrent_expected_launches(cfg, widths):
    """Launches of the engine's steps: a step of width T runs T one-token
    passes of the stack over the 8 slots, so every LUT launch is a GEMV (B1,
    and B3 for zamba2's QKV and gate+up) and B5 runs at T = 1; no step
    launches B2 or B4. Per pass: rwkv6 8 solo launches a layer (r, k, v, g,
    o, the channel mix's three), gla 6 (q, k, v, o solo as the JAX package
    calls them, the MLP's two), zamba2 2 a mamba layer (w_in, w_out) and per
    attention site 2 multi (QKV, gate+up), 2 solo (wo, w_down) and one B5."""
    from repro_torch.models.zamba2 import n_sites
    passes = sum(w * c for w, c in widths.items() if isinstance(w, int))
    sites = n_sites(cfg) if cfg.family == "hybrid" else 0
    solo = {"rwkv": 8, "linear_attn": 6, "hybrid": 2}[cfg.family] * cfg.n_layers + 2 * sites
    return {"lut_matmul_fused_multi_gemv": 2 * sites * passes, "lut_matmul_fused_multi": 0,
            "lut_matmul_fused_gemv": solo * passes, "lut_matmul_fused": 0,
            "paged_pool_attention": sites * passes, **NOT_SERVING}


def _rows_same(fn, *xs):
    """Whether fn over all rows of its inputs (axis 0: the slots) gives each
    row the bits of fn over that row alone (every output of a tuple)."""
    wide = fn(*xs)
    wide = wide if isinstance(wide, tuple) else (wide,)
    for i in range(xs[0].shape[0]):
        one = fn(*[x[i:i + 1] for x in xs])
        one = one if isinstance(one, tuple) else (one,)
        if not all(torch.equal(w[i:i + 1], o) for w, o in zip(wide, one)):
            return False
    return True


def _recurrent_row_ops(model, params):
    """Whether the ops a recurrent step adds give a slot's row the same bits
    alone (plain decode at batch 1) as among the engine's 8 slots: the final
    norm and the bf16 vocab head, the decay / gate LoRA products
    (`layers.row_stable_matmul`, layer 0's weights), the recurrence's token
    step (`_wkv_scan`, `_gla_scan`, `_ssd_scan`: output and new state, its
    sums elementwise) and zamba2's causal conv."""
    from repro_torch.models import gla, rwkv6, zamba2
    from repro_torch.models.layers import rmsnorm, row_stable_matmul
    from repro_torch.models.transformer import layer_slice
    cfg, f32 = model.cfg, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, dtype=f32, scale=1.0, uniform=False):
        x = (torch.rand if uniform else torch.randn)(shape, generator=gen, device="cuda")
        return (x * scale).to(dtype)

    rows_same = _rows_same
    p0 = layer_slice(params["blocks"], 0)
    scale = params["ln_final"]["scale"]
    ops = {}
    with torch.no_grad():
        x = rnd(8, 1, cfg.d_model, dtype=cfg.torch_dtype, scale=3.0)
        ops["rmsnorm"] = rows_same(lambda a: rmsnorm(a, scale), x)
        ops["lm_head"] = rows_same(lambda a: a @ params["lm_head"].to(a.dtype),
                                   rmsnorm(x, scale))
        if cfg.family == "hybrid":
            H, P, N, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
            ops["ssd_scan"] = rows_same(
                lambda xh, b, c, dt, s: zamba2._ssd_scan(xh, b, c, dt, p0["a_log"],
                                                         p0["d_skip"], s),
                rnd(8, 1, H, P), rnd(8, 1, N), rnd(8, 1, N),
                rnd(8, 1, H, scale=0.5, uniform=True), rnd(8, H, P, N))
            ops["causal_conv"] = rows_same(
                lambda a, st: zamba2._causal_conv(a, p0["conv"], st),
                rnd(8, 1, di, dtype=cfg.torch_dtype), rnd(8, cfg.ssm_conv - 1, di,
                                                          dtype=cfg.torch_dtype))
            return ops
        lora = p0["tm"] if cfg.family == "rwkv" else p0["attn"]
        a, b = ("decay_A", "decay_B") if cfg.family == "rwkv" else ("gate_A", "gate_B")
        xw = rnd(8, 1, cfg.d_model)
        ops["lora_in"] = rows_same(lambda v: row_stable_matmul(v, lora[a]), xw)
        ops["lora_out"] = rows_same(lambda v: row_stable_matmul(v, lora[b]),
                                    torch.tanh(row_stable_matmul(xw, lora[a])))
        H, P = cfg.rwkv_heads, cfg.rwkv_head_dim
        args = (rnd(8, 1, H, P), rnd(8, 1, H, P), rnd(8, 1, H, P),
                0.5 + rnd(8, 1, H, P, scale=0.5, uniform=True), rnd(8, H, P, P))
        if cfg.family == "rwkv":
            ops["wkv_scan"] = rows_same(
                lambda r, k, v, w, s: rwkv6._wkv_scan(r, k, v, w, lora["u"], s), *args)
        else:
            ops["gla_scan"] = rows_same(gla._gla_scan, *args)
    return ops


def phase_recurrent_parity(seed: int) -> dict:
    """Each recurrent arch at full width, LCD 4-bit, 2 layers (zamba2: its
    one attention site after them, the period being 6): the same params and
    serving
    steps (a prefill-width step with ragged n_new and an idle slot, then two
    decode steps) through the kernels and through their plain versions
    (`_plain_versions`), both on the card: in f32 with the float transform
    and in bf16 with the quantized one, at model_parity's limits; then the
    full-sequence forward (the chunked forms; the LUT GEMMs B2, and B4 for
    zamba2's shared block) at 4 x 64 = 256 rows in f32, kernels against
    plain at the same limits. Then B1 / B3 / B5 at the three archs' shapes,
    and B2 / B4 at them at the forward's 256 rows, against their plain
    versions, timed (`kernels_recurrent`). Returns the
    kernel sides' launch counts."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models.config import get_config

    s, t, nbw, nb, bs = 8, 32, 8, 64, 16
    variants = (("float32", False, 1e-3, 1e-4), ("bfloat16", True, 0.75, 0.03))
    report, counts = [], {}

    def count(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        for n, c in launch_counts().items():
            counts[n] = counts.get(n, 0) + c
        return out

    for arch, _ in RECURRENT_DEPTHS:
        # zamba2 at 2 layers, not 2 x attn_period = 12: its random weights
        # grow the residual stream by ~10^5 over 12 layers (a probe on the
        # card: 2.9e6 at the second site), which lifts the plain side's f32
        # logits differences to 0.034 and the bf16 quantized ones to 1.9
        layers, cfg0 = 2, get_config(arch)
        rng = np.random.default_rng(seed)
        tables = rng.permutation(nb)[:s * nbw].reshape(s, nbw).astype(np.int32)
        n_first = rng.integers(5, t + 1, s).astype(np.int32)
        n_first[3] = 0                                         # an idle slot
        active = n_first > 0
        steps = [(rng.integers(0, cfg0.vocab, (s, t)).astype(np.int32), n_first)]
        for _ in range(2):
            steps.append((rng.integers(0, cfg0.vocab, (s, 1)).astype(np.int32),
                          active.astype(np.int32)))
        fwd_tokens = torch.from_numpy(rng.integers(0, cfg0.vocab, (4, 64))).cuda()
        for dtype, quantized, tol_max, tol_mean in variants:
            model, p = _served_params(arch, seed, layers, dtype=dtype, quantized=quantized)
            def run():
                caches = model.init_seq_caches(num_blocks=nb, block_size=bs, num_slots=s,
                                               max_seq=nbw * bs, device="cuda")
                lengths, outs = np.zeros(s, np.int32), []
                for tokens, n_new in steps:
                    args = [torch.from_numpy(a).cuda() for a in (tokens, lengths, n_new, tables)]
                    with _no_host_sync():
                        lg, _ = model.serving_step(p, caches, *args)
                    outs.append(lg[active][:, :cfg0.vocab].float().cpu())
                    lengths = lengths + n_new
                return torch.stack(outs)

            logits = {"kernels": count(run)}
            with _plain_versions():
                logits["plain"] = run()
            report.append(_parity_row(logits, tol_max, tol_mean, arch=arch, layers=layers,
                                      dtype=dtype, quantized_transform=quantized,
                                      what="serving_step"))
            if dtype == "float32":
                fwd = {}
                with torch.no_grad():
                    with _plain_versions():
                        fwd["plain"] = model.apply(p, {"tokens": fwd_tokens})[0][..., :cfg0.vocab]
                    fwd["kernels"] = count(lambda: model.apply(p, {"tokens": fwd_tokens}))[0][
                        ..., :cfg0.vocab]
                report.append(_parity_row({k: v.float().cpu() for k, v in fwd.items()},
                                          tol_max, tol_mean, arch=arch, layers=layers,
                                          dtype=dtype, quantized_transform=quantized,
                                          what="forward", rows_per_launch=4 * 64))
                del fwd
            del p
            torch.cuda.empty_cache()
    emit("recurrent_parity", variants=report, launches=counts)
    if not all(r["ok"] for r in report):
        raise SystemExit(f"recurrent_parity: the kernels' and the plain versions' logits "
                         f"disagree: {[r for r in report if not r['ok']]}")
    missing = [n for n in PLAIN_LUT + ("paged_pool_attention",) if not counts.get(n)]
    if missing:
        raise SystemExit(f"recurrent_parity: {missing} never launched: {counts}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    # M = 8: a serving pass (B1, B3); M = 256: the forward's 4 x 64 rows (B2, B4)
    cases, worst = check_family_kernels(gen, archs=[a for a, _ in RECURRENT_DEPTHS],
                                        rows=(8, 256))
    emit("kernels_recurrent", cases=cases, worst=worst)
    return counts


def _preempt_check(engine, prompts, tokens, new_tokens) -> dict:
    """Four of the drive's prompts again on its engine, two of them preempted
    as they run (the first while it prefills, the next once it has decoded
    two tokens), then drained: every request's tokens must be the drive's,
    since a request's tokens do not depend on what shares its steps
    (engine = solo). rwkv6, gla and whisper keep a snapshot (the slot's rows
    copied out and back: `snapshot` / `restore` counted, no token fed twice,
    whisper's encoder run once a request), zamba2 recomputes. Returns the
    line's fields."""
    before = dict(engine.traces)
    fed = [0]
    inner = engine._model_step

    def counting(tok, n_new):
        fed[0] += int(n_new.sum())
        return inner(tok, n_new)
    engine._model_step = counting
    reqs = [_submit(engine, p, new_tokens) for p in prompts[:4]]
    mid = dec = None
    try:
        while engine.busy:
            running = [r for r in reqs if r.state == "running"]
            if mid is None:
                mid = next((r for r in running if r.prefilling and r.fed > 0), None)
                if mid is not None:
                    engine.preempt(mid)
            elif dec is None:
                dec = next((r for r in running if len(r.out_tokens) >= 2), None)
                if dec is not None:
                    engine.preempt(dec)
            engine.step()
    finally:
        del engine._model_step
    snap = engine.model.seq_caches["slot"].snapshot and not engine.has_paged
    delta = {k: engine.traces.get(k, 0) - before.get(k, 0)
             for k in ("snapshot", "restore", "slot_reset", "encode")}
    need = sum(len(p) for p in prompts[:4]) + 4 * (new_tokens - 1)
    # an encoder-decoder model encodes each request once: a restore brings
    # its cross K/V back with the rest of the slot's rows
    encodes = 4 if engine.model.cfg.is_encdec else 0
    ok = (mid is not None and dec is not None
          and [list(r.out_tokens) for r in reqs] == tokens[:4]
          and all(r.preemptions == any(r is x for x in (mid, dec)) for r in reqs)
          and delta["snapshot"] == delta["restore"] == (2 if snap else 0)
          and delta["encode"] == encodes
          and (fed[0] == need if snap else fed[0] > need))
    return dict(ok=ok, kind="snapshot" if snap else "recompute", traces_delta=delta,
                tokens_fed=fed[0], tokens_fed_unpreempted=need,
                same_tokens_as_drive=[list(r.out_tokens) for r in reqs] == tokens[:4])


def _recurrent_after_drive(name, seed):
    """`_serve`'s after_drive for a recurrent arch: the preemption check,
    `_row_count_ops` (the recurrent ops at 1 and 8 rows), a width-32 step's
    time through its graph with all 8 slots busy, and where a decode step's
    device time goes (`_step_breakdown` with the recurrent ranges: graph and
    eager body), each width's capture seconds; one line."""
    def after(engine, prompts, tokens):
        cfg = engine.model.cfg
        fails = []
        pre = _preempt_check(engine, prompts, tokens, len(tokens[0]))
        ops, _ = _row_count_ops(engine.model, engine.params, None)
        if not pre["ok"]:
            fails.append(f"preemption: {pre}")
        if not _row_count_ops_hold(ops):
            fails.append(f"row-count ops: {ops}")
        rng = np.random.default_rng(seed + 13)
        for _ in range(engine.ecfg.num_slots):
            # 4 prefill-width steps (one, then 2 timed: host clock and CUDA
            # events, profiler off; one replay timed 3 times over), then 10
            # decode steps (one, then the breakdown's graph 3, eager 3, wall 2)
            engine.submit(rng.integers(0, cfg.vocab, 128).astype(np.int32), max_new_tokens=11)
        ran = engine.traces.get(32, 0)
        engine.step()
        wall, span = _wall_ms_per_step(engine, 2)
        wide = dict(wall_ms_per_step=round(wall, 3), event_span_ms_per_step=round(span, 3),
                    device_ms_per_replay=round(_replay_ms(engine._graphs._graphs[32], n=3), 3))
        if engine.traces.get(32, 0) - ran != 3 or any(r is None for r in engine.slots):
            fails.append("the width-32 steps timed were not all of 8 busy slots")
        while any(r is not None and r.prefilling for r in engine.slots):
            engine.step()
        engine.step()
        prof = {"prefill_width_32": wide,
                "decode_width_1": _step_breakdown(engine, 1, 2, RECURRENT_RANGES, name)}
        engine.run()
        emit(name + "_checks", arch=cfg.arch_id, layers=cfg.n_layers, preemption=pre,
             row_count_ops=ops, step_ms_8_slots_busy=prof,
             graph_capture_s={str(w): round(c, 3)
                              for w, c in engine._graphs.capture_seconds().items()},
             slot_state_bytes=sum(t.numel() * t.element_size()
                                  for t in engine.caches["slot"].values()),
             paged_pool_bytes=sum(t.numel() * t.element_size()
                                  for t in engine.caches.get("paged", {}).values()))
        return fails
    return after


def phase_serve_recurrent(seed: int) -> dict:
    """rwkv6-1.6b, gla-1.3b and zamba2-1.2b served at full width and full
    depth like `serve`: LCD 4-bit weights from the seed with the quantized
    transform (gla's gate LoRA dense), the `serve` engine's geometry and 12
    requests of 40-200 prompt tokens, 24 new tokens each: launch counts per
    model step (every pass a GEMV: `_recurrent_expected_launches`), bounded
    shapes, every replay equal to its eager body in tokens and every cache
    tensor (`_graph_check`, a snapshot preemption inside for rwkv6 / gla),
    then on the same engine preemption (`_preempt_check`), the new ops'
    row bits (`_recurrent_row_ops`) and where a step's device time goes, then
    engine = solo tokens for 3 requests. Returns the drives' launches,
    summed over the archs."""
    total = {}
    for arch, layers in RECURRENT_DEPTHS:
        t0 = time.perf_counter()
        _, params = _served_params(arch, seed, layers)
        params_s = time.perf_counter() - t0
        counts, _ = _serve("serve_recurrent", arch, seed, layers, 12, 24, None,
                           solo_ids=(0, 5, 11), params=params,
                           after_drive=_recurrent_after_drive("serve_recurrent", seed))
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        del params
        torch.cuda.empty_cache()
        emit("serve_recurrent_arch", arch=arch, layers=layers,
             seconds=round(time.perf_counter() - t0, 1), weights_s=round(params_s, 1),
             peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    return total


# ---------------------------------------------------------------------------
# the audio family
# ---------------------------------------------------------------------------

AUDIO_ARCH = "whisper-large-v3"
AUDIO_DEPTH = 32                  # encoder and decoder layers each: full depth
# what whisper's path launches: every projection a solo LUT launch, B1 below
# 128 rows (a decode step: M = 8), B2 from 128 on (a width-32 step: M = 256;
# an encode: M = 1500); its attention is plain PyTorch, as in the JAX package
AUDIO_PATH = ("lut_matmul_fused_gemv", "lut_matmul_fused")
# the profiler ranges of whisper's admission and of its step's attention
AUDIO_RANGES = ("audio.encode", "audio.self_attn", "audio.cross_attn")
# whisper's projections at full width (20 heads padded to 32: 2048 wide), and
# how many of each (launches) a decoder layer's step, an encoder layer and a
# decoder layer's cross-K/V build run
AUDIO_SHAPES = {"1280 -> 2048 (q, k, v)": ((1280, 2048), 4, 3, 2),
                "2048 -> 1280 (o)": ((2048, 1280), 2, 1, 0),
                "1280 -> 5120 (mlp up)": ((1280, 5120), 1, 1, 0),
                "5120 -> 1280 (mlp down)": ((5120, 1280), 1, 1, 0)}
# bf16 with the quantized transform, kernels against plain versions: the
# limits of `model_parity`'s bf16 variant (a quantizer flip moves a row by
# s_q * centroid), stated before whisper's first run on the card
AUDIO_BF16_TOL = (0.75, 0.03)


def _audio_expected_launches(cfg, widths):
    """Launches of the engine's steps and encodes: a decoder layer's step
    runs 8 solo LUT launches (self q, k, v, o; cross q, o; the MLP's up and
    down), B1 at width 1 (M = 8) and B2 at width 32 (M = 256); an encode
    runs 6 B2 an encoder layer and 2 (cross k, v) a decoder layer, at 1500
    rows. No multi launch, no B5."""
    w1, w32, enc = widths.get(1, 0), widths.get(32, 0), widths.get("encode", 0)
    per_encode = 6 * cfg.n_enc_layers + 2 * cfg.n_layers
    return {"lut_matmul_fused_multi_gemv": 0, "lut_matmul_fused_multi": 0,
            "lut_matmul_fused_gemv": 8 * cfg.n_layers * w1,
            "lut_matmul_fused": 8 * cfg.n_layers * w32 + per_encode * enc,
            "paged_pool_attention": 0, **NOT_SERVING}


def _audio_launches_by_shape(cfg, widths):
    """`_audio_expected_launches` split by projection shape and row count."""
    w1, w32, enc = widths.get(1, 0), widths.get(32, 0), widths.get("encode", 0)
    return {name: {"B1 M=8": step * cfg.n_layers * w1, "B2 M=256": step * cfg.n_layers * w32,
                   "B2 M=1500": (enc_layer * cfg.n_enc_layers + cross * cfg.n_layers) * enc}
            for name, (_, step, enc_layer, cross) in AUDIO_SHAPES.items()}


def _audio_row_ops(model, params):
    """Whether the ops whisper's step adds give a slot's rows the same bits
    alone as among the engine's 8 slots: the ragged attention
    (`layers.ragged_attention`, `_attn_chunk` in 32-row query blocks) over
    the self K/V (per-slot positions and key counts, an idle slot among
    them) and over the cross K/V, at widths 1 and 32, the layernorm and the
    tied head; and whether a decoding slot's row gets the same bits at width
    1 as at the head of a 32-token window (a decoding slot in a mixed
    step), self and cross."""
    from repro_torch.models.layers import layernorm, ragged_attention
    cfg, dt = model.cfg, model.cfg.torch_dtype
    gen = torch.Generator(device="cuda").manual_seed(7)
    h, d, max_seq, es = cfg.n_heads_eff, cfg.hd, 512, cfg.enc_seq

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    lengths = torch.tensor([200, 37, 0, 95, 16, 470, 130, 63], dtype=torch.int32,
                           device="cuda")
    k_pos, e_pos = (torch.arange(n, device="cuda") for n in (max_seq, es))
    kw = dict(scale=1.0 / math.sqrt(d))
    dec = params["dec"]
    ops = {}
    with torch.no_grad():
        kc, vc, ck, cv = rnd(8, max_seq, h, d), rnd(8, max_seq, h, d), rnd(8, es, h, d), rnd(
            8, es, h, d)
        def self_attn(q, k, v, p, kl):
            return ragged_attention(q, k, v, p, k_pos, causal=True, k_len=kl, **kw)

        def cross_attn(q, k, v, p):
            return ragged_attention(q, k, v, p, e_pos, causal=False, **kw)

        wide = {}
        for t in (1, 32):
            n_new = torch.tensor([t, t, 0, 1, t, t, 1, t], dtype=torch.int32, device="cuda")
            pos = lengths[:, None] + torch.arange(t, device="cuda", dtype=torch.int32)[None]
            q = rnd(8, t, h, d)
            ops[f"self_attn_t{t}"] = _rows_same(self_attn, q, kc, vc, pos, lengths + n_new)
            ops[f"cross_attn_t{t}"] = _rows_same(cross_attn, q, ck, cv, pos)
            wide[t] = (q, pos)
        # one decoding token per slot: alone at width 1, then at the head of a
        # 32-token window whose other rows carry other queries
        q1 = wide[32][0][:, :1].contiguous()
        q32 = torch.cat([q1, wide[32][0][:, 1:]], dim=1)
        pos32, one = wide[32][1], lengths + 1
        ops["self_attn_t1_at_head_of_t32"] = torch.equal(
            self_attn(q1, kc, vc, pos32[:, :1], one), self_attn(q32, kc, vc, pos32, one)[:, :1])
        ops["cross_attn_t1_at_head_of_t32"] = torch.equal(
            cross_attn(q1, ck, cv, pos32[:, :1]), cross_attn(q32, ck, cv, pos32)[:, :1])
        x = (3.0 * torch.randn((8, 1, cfg.d_model), generator=gen, device="cuda")).to(dt)
        ln = dec["ln_final"]
        ops["layernorm"] = _rows_same(lambda a: layernorm(a, ln["scale"], ln["bias"]), x)
        ops["tied_head"] = _rows_same(lambda a: a @ dec["embed"].to(a.dtype).T,
                                      layernorm(x, ln["scale"], ln["bias"]))
    return ops


def _values_row(values, tol_max, tol_mean, **meta):
    """A tensor that is not logits (encoder output, cross K / V), kernels
    against plain: finite, max and mean |diff| within the limits."""
    diff = (values["kernels"] - values["plain"]).abs()
    row = dict(meta, max_abs_err=float(diff.max()), tol_max=tol_max,
               mean_abs_err=float(diff.mean()), tol_mean=tol_mean,
               abs_max=float(values["plain"].abs().max()))
    row["ok"] = (bool(torch.isfinite(values["kernels"]).all())
                 and row["max_abs_err"] <= tol_max and row["mean_abs_err"] <= tol_mean)
    return row


def phase_audio_parity(seed: int) -> dict:
    """whisper-large-v3 at full width, 2 encoder + 2 decoder layers, LCD
    4-bit from the seed: the same params, frames and steps through the
    kernels and through their plain versions (`_plain_versions`), both on
    the card, in f32 with the float transform (model_parity's limits) and in
    bf16 with the quantized one (`AUDIO_BF16_TOL`): `encode` of 2 requests
    (B2 at 3000 rows) and `build_cross_cache` over it, each live slot's
    `encode_prefill` (B2 at 1500 rows) written into its cross K/V as
    admission does, then a width-32 `serving_step` (ragged n_new, an idle
    slot: B2 at 256 rows) and two width-1 steps (B1 at 8), and the
    full-sequence forward of 2 x 64 tokens over 2 requests' frames. Then B1
    at M = 8 and B2 at M = 256 and 1500 at whisper's four projection shapes
    against their plain versions, timed (`kernels_audio`). Returns the
    kernel sides' launch counts."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import whisper
    from repro_torch.models.config import get_config

    s, t, max_seq = 8, 32, 256
    variants = (("float32", False, 1e-3, 1e-4), ("bfloat16", True) + AUDIO_BF16_TOL)
    cfg0 = get_config(AUDIO_ARCH)
    rng = np.random.default_rng(seed)
    n_first = rng.integers(5, t + 1, s).astype(np.int32)
    n_first[3] = 0                                         # an idle slot
    active = n_first > 0
    steps = [(rng.integers(0, cfg0.vocab, (s, t)).astype(np.int32), n_first)]
    for _ in range(2):
        steps.append((rng.integers(0, cfg0.vocab, (s, 1)).astype(np.int32),
                      active.astype(np.int32)))
    fwd_tokens = torch.from_numpy(rng.integers(0, cfg0.vocab, (2, 64))).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    frames = torch.randn((s, cfg0.enc_seq, cfg0.d_model), generator=gen, device="cuda")
    report, counts = [], {}

    def count(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        for n, c in launch_counts().items():
            counts[n] = counts.get(n, 0) + c
        return out

    for dtype, quantized, tol_max, tol_mean in variants:
        model, p = _served_params(AUDIO_ARCH, seed, 2, dtype=dtype, quantized=quantized)
        cfg = model.cfg

        def run():
            out = {}
            with torch.no_grad():
                enc = whisper.encode(p, frames[:2], cfg)
                out["encode"] = enc.float()
                ck, cv = whisper.build_cross_cache(p, enc, cfg)
                out["cross_k"], out["cross_v"] = ck.float(), cv.float()
                del enc, ck, cv
                caches = model.init_seq_caches(num_blocks=1, block_size=16, num_slots=s,
                                               max_seq=max_seq, device="cuda")
                for slot in np.flatnonzero(active):
                    ck, cv = model.encode_prefill(p, frames[slot:slot + 1])
                    caches["slot"]["ck"][:, slot].copy_(ck)
                    caches["slot"]["cv"][:, slot].copy_(cv)
                lengths, outs = np.zeros(s, np.int32), []
                tables = torch.zeros((s, 1), dtype=torch.int32, device="cuda")
                for tokens, n_new in steps:
                    args = [torch.from_numpy(a).cuda() for a in (tokens, lengths, n_new)]
                    with _no_host_sync():
                        lg, _ = model.serving_step(p, caches, *args, tables)
                    outs.append(lg[active][:, :cfg.vocab].float())
                    lengths = lengths + n_new
                out["width_32"], out["width_1"] = outs[0][None], torch.stack(outs[1:])
                del caches
                out["forward"] = model.apply(p, {"tokens": fwd_tokens, "frames": frames[:2]})[
                    0][..., :cfg.vocab].float()
            return out

        got = {"kernels": count(run)}
        with _plain_versions():
            got["plain"] = run()
        meta = dict(arch=AUDIO_ARCH, layers=2, enc_layers=2, dtype=dtype,
                    quantized_transform=quantized)
        for what in ("encode", "cross_k", "cross_v"):
            report.append(_values_row({k: v[what] for k, v in got.items()}, tol_max, tol_mean,
                                      what=what, **meta))
        for what, rows in (("width_32", int(active.sum())), ("width_1", int(active.sum())),
                           ("forward", 2 * 64)):
            report.append(_parity_row({k: v[what].cpu() for k, v in got.items()}, tol_max,
                                      tol_mean, what=what, rows_per_step=rows, **meta))
        del p, got
        torch.cuda.empty_cache()
    emit("audio_parity", variants=report, launches=counts)
    if not all(r["ok"] for r in report):
        raise SystemExit(f"audio_parity: the kernels' and the plain versions' outputs "
                         f"disagree: {[r for r in report if not r['ok']]}")
    missing = [n for n in AUDIO_PATH if not counts.get(n)]
    if missing:
        raise SystemExit(f"audio_parity: {missing} never launched: {counts}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 37)
    cases, worst = [], {}
    for m in (8, 256, 1500):
        for proj, ((k, n), *_) in AUDIO_SHAPES.items():
            case, kern = _lut_check(gen, m, k, n, 4, torch.bfloat16, True)
            case.update(arch=AUDIO_ARCH, group=proj,
                        **_time_lut(gen, kern, m, k, n, 4, torch.bfloat16, True))
            worst[case["kernel"]] = max(worst.get(case["kernel"], 0.0), case["max_abs_err"])
            cases.append(case)
    emit("kernels_audio", cases=cases, worst=worst)
    return counts


def _encode_check(engine, prompt):
    """The engine's `_slot_encode` of one request's frames into an idle slot
    (the engine idle: the next admission resets and re-encodes the slot):
    host seconds per encode (synchronised) and device ms by CUDA events, 3
    encodes each, and one encode under torch.profiler split into the LUT
    kernels and the rest, the `audio.encode` range around both."""
    from torch.profiler import ProfilerActivity, profile
    frames = _frames_of(engine, prompt).to(engine.model.cfg.torch_dtype)
    engine._slot_encode(0, frames)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        engine._slot_encode(0, frames)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        engine._slot_encode(0, frames)
    end.record()
    torch.cuda.synchronize()
    rows = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine._slot_encode(0, frames)
        torch.cuda.synchronize()
    for ev in prof.events():
        if ev.name == "audio.encode" and ev.device_type == torch.autograd.DeviceType.CPU:
            rows["audio.encode"] = rows.get("audio.encode", 0.0) + ev.device_time_total / 1e3
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key in AUDIO_RANGES:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        dev = ev.self_cuda_time_total if dev is None else dev
        if dev > 0:
            key = "lut_kernels" if "lut_" in ev.key else "other"
            rows[key] = rows.get(key, 0.0) + dev / 1e3
            rows["device_busy"] = rows.get("device_busy", 0.0) + dev / 1e3
    return dict(seconds_per_encode=round(wall, 4),
                device_ms_per_encode=round(start.elapsed_time(end) / 3, 3),
                profiled_ms={k: round(v, 3) for k, v in rows.items()})


def _audio_after_drive(name, seed):
    """`_serve`'s after_drive for whisper: the preemption check (snapshots,
    one encode a request), `_row_count_ops` (`_audio_row_ops` at 1 and 8
    slots), two requests with the drive's first prompt and different frames
    (other tokens) and with its own (the drive's tokens), seconds per
    encode (`_encode_check`), a width-32 step's time through its graph and
    where a decode step's device time goes with all 8 slots busy
    (`_step_breakdown` with `AUDIO_RANGES`), each width's capture seconds;
    one line."""
    from repro_torch.launch.engine import _tree_bytes
    from repro_torch.launch.serve import _dense_weight_bytes

    def after(engine, prompts, tokens):
        cfg = engine.model.cfg
        n = len(tokens[0])
        fails = []
        pre = _preempt_check(engine, prompts, tokens, n)
        ops, _ = _row_count_ops(engine.model, engine.params, None)
        if not pre["ok"]:
            fails.append(f"preemption: {pre}")
        if not _row_count_ops_hold(ops):
            fails.append(f"row-count ops: {ops}")
        own = _submit(engine, prompts[0], n)
        other = engine.submit(prompts[0], max_new_tokens=n,
                              frames=_frames_of(engine, prompts[0], salt=1))
        engine.run()
        frames_check = dict(same_frames_same_tokens=own.out_tokens == tokens[0],
                            other_frames_other_tokens=other.out_tokens != tokens[0],
                            other_tokens=other.out_tokens)
        if not (frames_check["same_frames_same_tokens"]
                and frames_check["other_frames_other_tokens"]):
            fails.append(f"frames: {frames_check}")
        enc = _encode_check(engine, prompts[0])
        rng = np.random.default_rng(seed + 13)
        for _ in range(engine.ecfg.num_slots):
            # 4 prefill-width steps (one, then 2 timed: host clock and CUDA
            # events, profiler off; one replay timed 3 times over), then 10
            # decode steps (one, then the breakdown's graph 3, eager 3, wall 2)
            _submit(engine, rng.integers(0, cfg.vocab, 128).astype(np.int32), 11)
        ran = engine.traces.get(32, 0)
        engine.step()
        wall, span = _wall_ms_per_step(engine, 2)
        wide = dict(wall_ms_per_step=round(wall, 3), event_span_ms_per_step=round(span, 3),
                    device_ms_per_replay=round(_replay_ms(engine._graphs._graphs[32], n=3), 3))
        if engine.traces.get(32, 0) - ran != 3 or any(r is None for r in engine.slots):
            fails.append("the width-32 steps timed were not all of 8 busy slots")
        while any(r is not None and r.prefilling for r in engine.slots):
            engine.step()
        engine.step()
        prof = {"prefill_width_32": wide,
                "decode_width_1": _step_breakdown(engine, 1, 2, AUDIO_RANGES, name)}
        engine.run()
        emit(name + "_checks", arch=cfg.arch_id, layers=cfg.n_layers,
             enc_layers=cfg.n_enc_layers, preemption=pre, row_count_ops=ops,
             frames=frames_check, encode=enc, step_ms_8_slots_busy=prof,
             graph_capture_s={str(w): round(c, 3)
                              for w, c in engine._graphs.capture_seconds().items()},
             slot_state_bytes={k: t.numel() * t.element_size()
                               for k, t in engine.caches["slot"].items()},
             param_bytes=_tree_bytes(engine.params),
             dense_param_bytes=_dense_weight_bytes(engine.params))
        return fails
    return after


def phase_serve_audio(seed: int) -> dict:
    """whisper-large-v3 served at full width and full depth (32 encoder + 32
    decoder layers) like `serve`: LCD 4-bit weights from the seed with the
    quantized transform, the `serve` engine's geometry, 12 requests of
    40-200 prompt tokens and 24 new tokens, each with its own frames
    (`_frames_of`), encoded once at admission: launch counts per step and
    encode (`_audio_expected_launches`), bounded shapes, every replay equal
    to its eager body in tokens and all four state tensors with a snapshot
    preemption inside (`_graph_check`), then on the same engine
    `_audio_after_drive`'s checks and times, then engine = solo tokens for 3
    requests. Returns the drive's launches."""
    t0 = time.perf_counter()
    _, params = _served_params(AUDIO_ARCH, seed, AUDIO_DEPTH)
    counts, _ = _serve("serve_audio", AUDIO_ARCH, seed, AUDIO_DEPTH, 12, 24, None,
                       solo_ids=(0, 5, 11), params=params,
                       after_drive=_audio_after_drive("serve_audio", seed))
    del params
    torch.cuda.empty_cache()
    emit("serve_audio_arch", arch=AUDIO_ARCH, layers=AUDIO_DEPTH, enc_layers=AUDIO_DEPTH,
         seconds=round(time.perf_counter() - t0, 1),
         peak_device_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    return counts


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _dryrun_matrix(multi_pod: bool, out_dir: str) -> dict:
    """Every cell of `--all` on a production mesh (`dryrun.run_all`), dense
    and, for the decode shapes, `--lcd`: the count of ok / skipped / error
    cells, each dominant term, and the largest total_per_chip against the
    card's memory."""
    from collections import Counter

    from repro_torch.distributed.cost import HBM_BYTES
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES
    decode = [name for name, sc in SHAPES.items() if sc.kind == "decode"]
    cells = (dryrun.run_all(multi_pod, False, out_dir)
             + dryrun.run_all(multi_pod, True, out_dir, shapes=decode))
    ok = [c for c in cells if c["status"] == "ok"]
    big = max(ok, key=lambda c: c["memory"]["total_per_chip"])
    return dict(mesh="(2, 16, 16)" if multi_pod else "(16, 16)",
                cells_ok=len(ok), skipped=sum(c["status"] == "skipped" for c in cells),
                errors=[c for c in cells if c["status"] == "error"],
                dominant=dict(Counter(c["dominant"] for c in ok)),
                fit_80gb=sum(c["hbm_ok"] for c in ok),
                largest_total_per_chip_gb=round(big["memory"]["total_per_chip"] / 1e9, 3),
                largest_cell=big["cell"], card_memory_gb=HBM_BYTES / 1e9)


# the dry run against the card: a drive's own peak within this factor of the
# predicted total_per_chip either way, and the train step's measured time at
# most this many times its roofline (the ratio sat at 1.57 on the H100: a lost
# factor in the count of its FLOPs or bytes lands outside); the decode step's
# roofline is held from below only (7.2 x: the step is launch-bound)
DRYRUN_PEAK_FACTOR = 2.0
DRYRUN_TRAIN_T_MAX = 3.0


def _drive_check(name, predicted, measured_inputs, measured_peak, measured_s, extra,
                 t_max=None) -> dict:
    """One drive held to the dry run: argument bytes equal, the drive's own
    peak at least the argument bytes and within DRYRUN_PEAK_FACTOR of the
    predicted total, the step's time at least the roofline's (and at most
    `t_max` times it, where given)."""
    arg, total, t_step = predicted
    ratio = measured_s / t_step
    row = dict(drive=name, predicted_argument_bytes=arg, measured_input_bytes=measured_inputs,
               argument_equal=arg == measured_inputs,
               predicted_total_per_chip=total, measured_peak_bytes=measured_peak,
               peak_over_predicted_total=round(measured_peak / total, 4),
               peak_at_least_argument=measured_peak >= arg,
               peak_within_factor=1 / DRYRUN_PEAK_FACTOR <= measured_peak / total
               <= DRYRUN_PEAK_FACTOR,
               predicted_t_step_s=t_step, measured_step_s=measured_s,
               measured_over_predicted_t=round(ratio, 4),
               time_at_least_roofline=ratio >= 1.0,
               time_at_most=t_max, time_within_bound=t_max is None or ratio <= t_max, **extra)
    row["ok"] = all(row[k] for k in ("argument_equal", "peak_at_least_argument",
                                     "peak_within_factor", "time_at_least_roofline",
                                     "time_within_bound"))
    return row


def phase_dryrun(train_drive, profile_drive) -> None:
    """The dry run (`repro_torch.launch.dryrun`, every tensor on "meta"):
    the `--all` matrix on (16, 16) and (2, 16, 16), dense and `--lcd` for the
    decode shapes, the JSON of each cell in a temporary directory, one line
    a mesh (any cell in error fails the phase); then the dry run's 1 x 1
    predictions for two drives this script runs, held to their
    measurements by `_drive_check`: `train`'s step (llama2-7b, 4 layers, f32, 8 x 512; its
    steady seconds a step on the host's clock) and `profile`'s graph decode
    step (llama2-7b, 32 layers, 4-bit LCD with the quantized transform, 8
    slots busy; its device ms a step). A drive whose phase did not run is
    reported as not run."""
    import logging
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig, get_config
    from repro_torch.models.registry import get_model
    fails = []
    log = logging.getLogger("repro_torch")
    level = log.level
    log.setLevel(logging.WARNING)
    try:
        with tempfile.TemporaryDirectory(prefix="dryrun_") as out:
            for multi_pod in (False, True):
                row = _dryrun_matrix(multi_pod, out)
                emit("dryrun", **row)
                if row["errors"]:
                    fails.append(f"{row['mesh']}: {len(row['errors'])} cells in error")
    finally:
        log.setLevel(level)
    one = make_mesh((1, 1), ("data", "model"), [torch.device("meta")])
    checks = []
    drive = train_drive
    if drive is None:
        checks.append(dict(drive="train", status="not run"))
    else:
        cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=TRAIN_LAYERS,
                                  dtype="float32")
        r = dryrun.analyze_cell(get_model(cfg), ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                                            "train"), one)
        checks.append(_drive_check(
            "train", (r["memory"]["argument_size"], r["memory"]["total_per_chip"], r["t_step"]),
            drive["input_bytes"], drive["peak_bytes"], drive["s_per_step"],
            dict(measured_step_from="steady mean of the host's seconds a step",
                 predicted_dominant=r["dominant"], t_compute_s=r["t_compute"],
                 t_memory_s=r["t_memory"]), t_max=DRYRUN_TRAIN_T_MAX))
    drive = profile_drive
    if drive is None:
        checks.append(dict(drive="profile", status="not run"))
    else:
        ecfg = drive["ecfg"]
        model = get_model(dataclasses.replace(get_config("llama2-7b"), n_layers=32))
        r = dryrun.analyze_cell(model, ShapeConfig("decode", ecfg.max_seq, ecfg.num_slots,
                                                   "decode"), one, lcd=True,
                                params=dryrun.lcd_abstract(model, calibrated=True), ecfg=ecfg)
        e = r["engine"]
        checks.append(_drive_check(
            "profile decode", (e["argument_size"], e["total_per_chip"], r["t_step"]),
            drive["input_bytes"], drive["peak_bytes"], drive["device_ms"] / 1e3,
            dict(measured_step_from=f"device ms a graph step ({drive['device_ms_from']})",
                 predicted_dominant=r["dominant"], t_compute_s=r["t_compute"],
                 t_memory_s=r["t_memory"])))
    for row in checks:
        emit("dryrun_check", **row)
        if row.get("ok") is False:
            fails.append(f"{row['drive']}: the card disagrees with the dry run")
    if fails:
        raise SystemExit("dryrun: " + "; ".join(fails))


ALL_PHASES = ("kernels", "autotune", "lut_layer", "model_parity", "serve", "serve_mesh",
              "serve_processes", "serve_unfused", "serve_static", "serve_int8", "serve_gqa",
              "serve_spec",
              "serve_prefix", "serve_prefix_spec", "serve_prefix_int8", "serve_sched",
              "serve_family", "serve_spec_family", "compress", "profile", "moe_parity",
              "serve_moe", "recurrent_parity", "serve_recurrent", "audio_parity",
              "serve_audio", "serve_mesh_family", "train", "train_mesh", "dryrun")
# the phases served on the `serve` phase's llama2-7b weights (the 4-layer ones on
# their first 4 layers)
ON_SERVE_WEIGHTS = {"serve", "serve_mesh", "serve_processes", "serve_unfused", "serve_static",
                    "profile", "serve_prefix", "serve_prefix_spec", "serve_prefix_int8",
                    "serve_sched"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of the phases to run after env and build")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "on a CUDA card only", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in full f32
    torch.set_float32_matmul_precision("highest")
    phases = [p for p in args.phases.split(",") if p]

    seconds, peak_gib = {}, {}

    def timed(name, fn, *a, **kw):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = round(time.perf_counter() - t0, 1)
        peak_gib[name] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
        peak_gib["run"] = max(peak_gib.get("run", 0.0), peak_gib[name])
        return out

    t_start = time.perf_counter()
    smi = timed("env", phase_env)
    timed("build", phase_build)
    checked = timed("kernels", phase_kernels, args.seed) if "kernels" in phases else {}
    # the attention kernels' path: their entry points with the tile left to the tuner
    tune_counts, tune_heads = (timed("autotune", phase_autotune, args.seed)
                               if "autotune" in phases else ({}, {}))
    # the §4 layer's path: its own launch counts
    layer_counts = timed("lut_layer", phase_lut_layer, args.seed) if "lut_layer" in phases else {}
    if "model_parity" in phases:
        timed("model_parity", phase_model_parity, args.seed)
    # llama2-7b, full width and depth: one set of weights for every phase below
    params = None
    if ON_SERVE_WEIGHTS & set(phases):
        _, params = timed("weights", _served_params, "llama2-7b", args.seed, 32)
    counts, tokens = {}, None
    if "serve" in phases:
        counts, tokens = timed("serve", _serve, "serve", "llama2-7b", args.seed, 32, 12, 24,
                               None, solo_ids=(0, 11), params=params)
    # the same weights and drive on (data, model) meshes of the card, counted on their own
    mesh_counts = (timed("serve_mesh", phase_serve_mesh, args.seed, params)
                   if "serve_mesh" in phases else {})
    # the same weights at 4 layers on a process mesh: two processes on the card
    # over gloo, each holding its own shards, counted on their own
    process_counts = (timed("serve_processes", phase_serve_processes, args.seed, params, smi)
                      if "serve_processes" in phases else {})
    if "serve_unfused" in phases:
        # the same prompts through per-projection launches: the same tokens
        timed("serve_unfused", _serve, "serve_unfused", "llama2-7b", args.seed, 32, 12, 24,
              None, solo_ids=(), fused=False, params=params, want_tokens=tokens)
    if "serve_static" in phases:
        timed("serve_static", phase_serve_static, args.seed, params)
    if "serve_int8" in phases:
        timed("serve_int8", _serve, "serve_int8", "llama2-7b", args.seed, 4, 4, 24, "int8",
              solo_ids=(1, 3))
    if "serve_gqa" in phases:
        # a second model's shapes: 16 (padded) query heads over 2 kv heads, QKV bias,
        # K = 1536 / 8960, so 256 query rows per (slot, kv head) on a prefill step
        timed("serve_gqa", _serve, "serve_gqa", "qwen2-1.5b", args.seed, 4, 4, 24, None,
              solo_ids=(0, 2))
    # speculative self-drafting: llama2-7b full width, 4 layers, its own launch counts
    spec_counts = timed("serve_spec", phase_serve_spec, args.seed) if "serve_spec" in phases else {}
    # the engine's production features, each path with its own launch counts
    feature_counts = {}
    for name, fn in (("serve_prefix", phase_serve_prefix),
                     ("serve_prefix_spec", phase_serve_prefix_spec),
                     ("serve_prefix_int8", phase_serve_prefix_int8),
                     ("serve_sched", phase_serve_sched)):
        if name in phases:
            feature_counts[name] = timed(name, fn, args.seed, params)
    # the rest of the transformer family, each arch with its own launch counts
    family_counts = (timed("serve_family", phase_serve_family, args.seed)
                     if "serve_family" in phases else {})
    family_spec_counts = (timed("serve_spec_family", phase_serve_spec_family, args.seed)
                          if "serve_spec_family" in phases else {})
    if "compress" in phases:
        timed("compress", phase_compress, args.seed)
    profile_drive = (timed("profile", phase_profile, args.seed, params)
                     if "profile" in phases else None)
    params = None                       # the serve weights are not needed any more
    # the MoE family: the kernels against their plain versions inside a 2-layer
    # model and at the archs' shapes, then served at full width, each path
    # counted on its own
    moe_parity_counts = (timed("moe_parity", phase_moe_parity, args.seed)
                         if "moe_parity" in phases else {})
    moe_counts = timed("serve_moe", phase_serve_moe, args.seed) if "serve_moe" in phases else {}
    if "serve_moe" in phases and not all(moe_counts.get(n, 0) > 0 for n in MOE_PATH_KERNELS):
        print(f"chip_smoke: serve_moe did not launch every kernel of its path: {moe_counts}",
              file=sys.stderr)
        return 1
    # the recurrent and hybrid families: the kernels against their plain
    # versions inside 2-layer models (their forward too: B2 / B4) and at the
    # archs' shapes, then served at full width and depth, counted on their own
    recurrent_parity_counts = (timed("recurrent_parity", phase_recurrent_parity, args.seed)
                               if "recurrent_parity" in phases else {})
    recurrent_counts = (timed("serve_recurrent", phase_serve_recurrent, args.seed)
                        if "serve_recurrent" in phases else {})
    if "serve_recurrent" in phases and not all(
            recurrent_counts.get(n, 0) > 0 for n in RECURRENT_PATH["hybrid"]):
        print(f"chip_smoke: serve_recurrent did not launch every kernel of its path: "
              f"{recurrent_counts}", file=sys.stderr)
        return 1
    # the audio family: the kernels against their plain versions inside a
    # 2 + 2-layer whisper (encoder, cross-K/V build, steps, forward) and at its
    # shapes, then served at full width and depth, counted on their own
    audio_parity_counts = (timed("audio_parity", phase_audio_parity, args.seed)
                           if "audio_parity" in phases else {})
    audio_counts = (timed("serve_audio", phase_serve_audio, args.seed)
                    if "serve_audio" in phases else {})
    if "serve_audio" in phases and not all(audio_counts.get(n, 0) > 0 for n in AUDIO_PATH):
        print(f"chip_smoke: serve_audio did not launch every kernel of its path: "
              f"{audio_counts}", file=sys.stderr)
        return 1
    # every other family on (1, 2) and (2, 1) meshes of the card, counted on its own
    mesh_family_counts = (timed("serve_mesh_family", phase_serve_mesh_family, args.seed)
                          if "serve_mesh_family" in phases else {})
    # the trainer and the paper's pipeline: the student's forward (B2 / B4 at
    # 4096 rows) and its engine (B1-B5), counted on their own; B2 / B4 at
    # those rows against their plain versions, timed
    train_counts, train_cases, one_by_one, train_drive = ({}, {}, None, None)
    if "train" in phases:
        train_counts, train_cases, one_by_one, train_drive = timed("train", phase_train,
                                                                   args.seed)
    # training on (data, model) meshes of the card: the dense step, which
    # launches no hand-written kernel; its count is printed, not required
    train_mesh_counts = (timed("train_mesh", phase_train_mesh, args.seed, one_by_one)
                         if "train_mesh" in phases else {})
    one_by_one = None
    # the dry run over every cell, and its predictions for the train and
    # profile drives held to their measurements
    if "dryrun" in phases:
        timed("dryrun", phase_dryrun, train_drive, profile_drive)
    emit("timing", seconds=seconds, total_s=round(time.perf_counter() - t_start, 1),
         peak_device_memory_gib=peak_gib)

    meta = {
        "lut_matmul_fused_gemv": ("src/repro_torch/kernels/csrc/lut_gemv.cu",
                                  "src/repro/kernels/lut_matmul.py:404"),
        "lut_matmul_fused": ("src/repro_torch/kernels/csrc/lut_gemm.cu",
                             "src/repro/kernels/lut_matmul.py:334"),
        "lut_matmul_fused_multi_gemv": ("src/repro_torch/kernels/csrc/lut_multi_gemv.cu",
                                        "src/repro/kernels/lut_matmul.py:646"),
        "lut_matmul_fused_multi": ("src/repro_torch/kernels/csrc/lut_multi_gemm.cu",
                                   "src/repro/kernels/lut_matmul.py:583"),
        "paged_pool_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                 "src/repro/kernels/paged_attention.py:419"),
        "lut_matmul_f32": ("src/repro_torch/kernels/csrc/lut_plain.cu",
                           "src/repro/kernels/lut_matmul.py:187"),
        "lut_matmul_int8": ("src/repro_torch/kernels/csrc/lut_plain.cu",
                            "src/repro/kernels/lut_matmul.py:234"),
        "smooth_quant": ("src/repro_torch/kernels/csrc/smooth_quant.cu",
                         "src/repro/kernels/smooth_quant.py:46"),
        "paged_dequant_attention": ("src/repro_torch/kernels/csrc/paged_dequant.cu",
                                    "src/repro/kernels/paged_attention.py:151"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:108"),
        # no TPU kernel: the reference leaves the projection's backward to XLA
        "split_bf16": ("src/repro_torch/kernels/csrc/lut_backward.cu",
                       "none (the backward kernels' pre-pass; XLA's backward of "
                       "src/repro/core/api.py:119 clustered_matmul)"),
        "lut_matmul_t": ("src/repro_torch/kernels/csrc/lut_backward.cu",
                         "none (XLA's backward of src/repro/core/api.py:119 clustered_matmul)"),
        "lut_codebook_grad": ("src/repro_torch/kernels/csrc/lut_backward.cu",
                              "none (XLA's backward of src/repro/core/api.py:119 "
                              "clustered_matmul)"),
    }
    # launches: the serving path's run for B1-B5, the §4 layer's for B6, B7,
    # B10, the tuned attention path's for B8, B9, the trainer's pipeline
    # (its fine-tune) for the backward kernels
    launches = {**{n: counts.get(n, 0) for n in meta},
                **{n: train_counts.get(n, 0) for n in BACKWARD_KERNELS},
                **{n: layer_counts.get(n, 0) for n in ("lut_matmul_f32", "lut_matmul_int8",
                                                       "smooth_quant")},
                **{n: tune_counts.get(n, 0) for n in ("paged_dequant_attention",
                                                      "flash_attention")}}
    kernels = []
    for name, (source, replaces) in meta.items():
        head, worst = checked.get(name, ({}, None))
        head = tune_heads.get(name, head)
        if name in BACKWARD_KERNELS and train_cases.get(name):
            # the headline: llama's gate / up projection, 4096 -> 11008
            head = next(c for c in train_cases[name] if c["n"] == 11008)
            worst = max(c["max_abs_err"] for c in train_cases[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst,
            # the speculative engine's run (serve_spec), counted on its own
            "launches_serve_spec": spec_counts.get(name, 0),
            # the serve drive on (1, 2) and (2, 1) meshes of the card and the
            # int8 pool on (2, 2): every rank's launches
            "launches_serve_mesh": mesh_counts.get(name, 0),
            # the MoE, recurrent, hybrid and audio drives on the same meshes
            "launches_serve_mesh_family": mesh_family_counts.get(name, 0),
            # the serve weights at 4 layers on (1, 2) and (2, 1) process
            # meshes: both processes' launches
            "launches_serve_processes": process_counts.get(name, 0),
            # the rest of the family: its full-depth drives and its speculative ones
            "launches_serve_family": family_counts.get(name, 0),
            "launches_serve_spec_family": family_spec_counts.get(name, 0),
            # the production features: each path's drive, counted on its own
            **{f"launches_{phase}": c.get(name, 0) for phase, c in feature_counts.items()},
            # the MoE family: the 2-layer model's kernel side, and its serving drives
            "launches_moe_parity": moe_parity_counts.get(name, 0),
            "launches_serve_moe": moe_counts.get(name, 0),
            # the recurrent and hybrid families: the 2-layer models' kernel side
            # (serving steps and the forward), and their full-depth drives
            "launches_recurrent_parity": recurrent_parity_counts.get(name, 0),
            "launches_serve_recurrent": recurrent_counts.get(name, 0),
            # the audio family: the 2 + 2-layer model's kernel side, and its
            # full-depth drive (encodes included)
            "launches_audio_parity": audio_parity_counts.get(name, 0),
            "launches_serve_audio": audio_counts.get(name, 0),
            # the trainer's pipeline: the student's evaluation and its engine
            "launches_train": train_counts.get(name, 0),
            # training on meshes of the card (dense weights: none expected)
            "launches_train_mesh": train_mesh_counts.get(name, 0),
            "train_shapes": [{k: c.get(k) for k in (
                "group", "m", "k", "n", "widths", "dtype", "ms", "plain_ms", "bound_ms",
                "bound_by", "f32_core_bound_ms", "max_abs_err", "solo_sum_ms", "yardstick_ms",
                "errs", "tols", "same_bits_twice", "nbits", "ms_given_split", "equal")
                if k in c}
                for c in train_cases.get(name, [])],
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"), "bound_by": head.get("bound_by"),
            "f32_core_bound_ms": head.get("f32_core_bound_ms"),
            # one PyTorch call computes the same function only for B9 (the
            # library attention); for the others there is none
            "library_ms": head.get("library_ms"),
            # the backward kernels' yardstick: torch.matmul over the
            # dequantised f32 weight
            "yardstick_ms": head.get("yardstick_ms"),
            "ms_given_split": head.get("ms_given_split"),
            "dense_bf16_matmul_ms": head.get("dense_bf16_matmul_ms"),
            "sdpa_dense_bf16_ms": head.get("sdpa_dense_bf16_ms"),
            "solo_sum_ms": head.get("solo_sum_ms"),
            "decode_window": head.get("decode_window"),
            "shape": {k: head[k] for k in ("group", "case", "m", "k", "n", "c", "widths",
                                           "nbits", "s", "t", "h", "kv", "l", "l_pad", "bh",
                                           "sq", "sk", "d", "bq", "bk", "pool", "dtype")
                      if k in head},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    complete = set(phases) >= set(ALL_PHASES)
    if complete and not all(k["launches"] > 0 and k["ms"] for k in kernels):
        print("chip_smoke: a kernel of the main path was never launched", file=sys.stderr)
        return 1
    if complete and not all(k["launches_serve_mesh"] > 0 and k["launches_serve_mesh_family"] > 0
                            and k["launches_serve_processes"] > 0
                            for k in kernels if k["name"] in MESH_PATH):
        print("chip_smoke: a kernel of the mesh path was never launched", file=sys.stderr)
        return 1
    if complete and not all(k["launches_train"] > 0 for k in kernels
                            if k["name"] in TRAIN_PATH_KERNELS):
        print("chip_smoke: a kernel of the trainer's pipeline was never launched",
              file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps({"ok": complete, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0 if complete else 4


if __name__ == "__main__":
    sys.exit(main())
