"""Model-facing wrappers around the LUT kernels: operand preparation, variant
selection, and the launch counters.

`clustered_linear(x, ct)` and `clustered_linear_multi(x, cts)` are the
entries the models call. Where nothing is differentiated they run the fused
smooth(+quant)+LUT contraction streaming the tensors' packed codes (Eq. 11
through `inv_scale`): the CUDA kernels for CUDA tensors, their plain versions
for CPU tensors (the choice is made by where the tensor lies, in the kernel
wrappers, and nowhere else). A call that autograd would differentiate
computes what the reference differentiates, `(x / smooth) @
codebook[codes]` in float: on the CPU the plain `core/api.py
clustered_matmul`, on the card `_LutProjections`, whose forward runs B1-B4
with the float transform and whose backward runs `split_bf16`,
`lut_matmul_t` and `lut_codebook_grad`. `lut_gemm` and `lut_gemm_int8`
serve the paper's §4 layer: already-smoothed float activations, and int8
Eq. 11 codes.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.api import ClusteredTensor, clustered_matmul
from repro_torch.core.lut import packed_rows, padded_d_in
from repro_torch.kernels import lut_matmul as _lm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import smooth_quant as _sq
# by name: the package's attribute `flash_attention` is the function (__init__)
from repro_torch.kernels.flash_attention import LAUNCHES as _FA_LAUNCHES
from repro_torch.kernels.lut_matmul import (KC, lut_codebook_grad, lut_matmul_f32,
                                            lut_matmul_fused,
                                            lut_matmul_fused_gemv,
                                            lut_matmul_fused_multi,
                                            lut_matmul_fused_multi_gemv,
                                            lut_matmul_int8, lut_matmul_t,
                                            split_bf16)

GEMV_MAX_M = 128   # M < 128 goes to the GEMV kernel, else to the GEMM kernel


# ---------------------------------------------------------------------------
# Launch counters (the counterpart of the JAX package's track_lut_launches)
# ---------------------------------------------------------------------------

def _counters():
    return (_lm.LAUNCHES, _pa.LAUNCHES, _sq.LAUNCHES, _FA_LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last `reset_launch_counts()`. A
    wrapper adds one where it launches its kernel and nowhere else; the plain
    versions that serve CPU tensors are not counted. A CUDA graph runs no
    wrapper when it is replayed: its replay adds the tally its capture
    recorded (`capture_launches`, `add_launches`)."""
    return {name: n for counts in _counters() for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _counters():
        for name in counts:
            counts[name] = 0


def add_launches(tally: Dict[str, int], times: int = 1) -> None:
    """Add `times` x `tally` to the counters: what `times` replays of a
    graph whose capture recorded `tally` launched."""
    for counts in _counters():
        for name in counts:
            counts[name] += times * tally.get(name, 0)


@contextlib.contextmanager
def capture_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA-graph capture: what the wrappers count inside the block
    fills the yielded dict, the graph's launches per replay, and is taken
    back out of the counters, since a capture launches nothing. The
    counterpart of the JAX package's trace-time tags, where one traced step
    is the per-step launch count."""
    before = launch_counts()
    tally: Dict[str, int] = {}
    try:
        yield tally
    finally:
        after = launch_counts()
        tally.update({n: after[n] - before[n] for n in after if after[n] != before[n]})
        add_launches(tally, -1)


# ---------------------------------------------------------------------------
# Operand preparation
# ---------------------------------------------------------------------------

def pad_codebook(codebook: torch.Tensor) -> torch.Tensor:
    """Zero-pad the active centroids up to the kernel's KC=16 capacity.
    Padded slots decode to 0 and are never referenced by valid codes."""
    k = codebook.shape[0]
    if k == KC:
        return codebook.to(torch.float32)
    if k > KC:
        raise ValueError(
            f"pad_codebook: codebook has K={k} centroids but the kernel "
            f"supports K<=KC={KC} (paper: distillation yields <16)")
    return F.pad(codebook.to(torch.float32), (0, KC - k))


def packed_view(ct: ClusteredTensor) -> torch.Tensor:
    """The tensor's packed sub-byte codes (at ct.nbits per code): the
    first-class `packed` field, or codes already stored packed
    (materialized serving trees). Unpacked codes without a `packed` field are
    refused: packing happens once, when the tensor is assembled
    (core/api.py dense_to_clustered), never per call."""
    if ct.packed is not None:
        return ct.packed
    d_in = ct.smooth.shape[-1]
    if ct.codes.shape[-2] == packed_rows(d_in, ct.nbits):
        return ct.codes if ct.codes.dtype == torch.uint8 else ct.codes.to(torch.uint8)
    raise ValueError(
        f"packed_view: ClusteredTensor has unpacked codes {tuple(ct.codes.shape)} "
        f"and no `packed` field; assemble it with dense_to_clustered")


def _transform_params(ct: ClusteredTensor):
    """(inv_scale, act_scale, quantize) for the fused kernel — precomputed
    fields when present, else derived from the smoothing vector alone."""
    quantize = ct.act_scale is not None
    if ct.inv_scale is not None:
        inv = ct.inv_scale
    else:
        inv = 1.0 / ct.smooth
        if quantize:
            inv = inv / ct.act_scale
    act = ct.act_scale if quantize else 1.0
    return inv.to(torch.float32), act, quantize


def _pad_k(a: torch.Tensor, nbits: int) -> torch.Tensor:
    """Zero columns up to a whole packing group of K (the packed codes carry
    zero-code tail rows there)."""
    k = a.shape[1]
    kc = padded_d_in(k, nbits)
    return (F.pad(a, (0, kc - k)) if kc != k else a).contiguous()


def lut_gemm(
    x: torch.Tensor,            # (M, K) float activations, already smoothed
    packed_codes: torch.Tensor, # (packed_rows(K), N) uint8
    codebook: torch.Tensor,     # (K_active,) f32
    *,
    nbits: int = 4,
) -> torch.Tensor:
    """Float-activation LUT GEMM, Y = x @ codebook[codes] (f32): the codebook
    padded to KC, K to a whole packing group; ragged M and N are the
    kernel's."""
    return lut_matmul_f32(_pad_k(x, nbits), packed_codes, pad_codebook(codebook),
                          nbits=nbits)


def lut_gemm_int8(
    q: torch.Tensor,            # (M, K) int8 Eq. 11 codes
    packed_codes: torch.Tensor, # (packed_rows(K), N) uint8
    codebook: torch.Tensor,     # (K_active,) f32
    act_scale,                  # () f32 s_q
    *,
    nbits: int = 4,
) -> torch.Tensor:
    """The paper's §4 LUT GEMM, Y = s_q * (q @ codebook[codes]) (f32), s_q
    applied inside the kernel as the reference applies it inside
    `lut_matmul_int8`; padding as `lut_gemm`."""
    return lut_matmul_int8(_pad_k(q, nbits), packed_codes, pad_codebook(codebook),
                           act_scale, nbits=nbits)


def lut_gemm_fused(
    x: torch.Tensor,            # (M, K) RAW activations (smoothing NOT applied)
    inv_scale: torch.Tensor,    # (K,) f32 — Eq. 11 fused multiplier
    packed_codes: torch.Tensor, # (packed_rows(K), N) uint8
    codebook: torch.Tensor,     # (K_active,) f32
    act_scale,                  # () f32 s_q (pass 1.0 when quantize=False)
    *,
    quantize: bool = True,
    nbits: int = 4,
) -> torch.Tensor:
    """Single-pass serving GEMM: smooth(+quant) fused into the LUT matmul's
    K loop — no standalone smooth pass, no intermediate activation tensor in
    device memory. Decode shapes (M < 128) dispatch to the GEMV kernel. The
    kernels mask ragged M and N themselves; only the packing-group padding of
    K (2, 8 or 4 rows) is applied here."""
    cb = pad_codebook(codebook)
    m, k = x.shape
    kc = padded_d_in(k, nbits)
    inv_scale = inv_scale.to(torch.float32)
    if kc != k:  # group padding: packed codes carry zero-code tail rows
        x = F.pad(x, (0, kc - k))
        inv_scale = F.pad(inv_scale, (0, kc - k))
    kern = lut_matmul_fused_gemv if m < GEMV_MAX_M else lut_matmul_fused
    y = kern(x.contiguous(), inv_scale.contiguous(), packed_codes, cb,
             quantize=quantize, nbits=nbits)
    return y * act_scale if quantize else y


def _reaches_kernel(x: torch.Tensor) -> bool:
    """Whether a call on `x` launches a CUDA kernel: the wrappers send a CUDA
    tensor to the kernel and any other to its plain version."""
    return x.device.type == "cuda"


def _needs_grad(x: torch.Tensor, cts) -> bool:
    """Whether autograd would differentiate the call: grad mode on, and x or
    a float field of a tensor requiring grad."""
    if not torch.is_grad_enabled():
        return False
    fields = [getattr(ct, f) for ct in cts
              for f in ("codebook", "smooth", "inv_scale", "act_scale")]
    return x.requires_grad or any(f is not None and f.requires_grad for f in fields)


class _LutProjections(torch.autograd.Function):
    """P projections sharing x (P = 1: a solo one), differentiated as the
    reference differentiates `clustered_matmul`: y_p = (x / smooth_p) @
    codebook_p[codes_p], in float. `inv_scale` and `act_scale` are not read.

    Forward: B1 / B2 (P = 1) or B3 / B4 with the float transform and inv =
    1 / smooth_p. Backward, per projection in order: dY_p's `split_bf16`
    parts, which both kernels read; dXs_p by `lut_matmul_t`, dx += dXs_p /
    smooth_p; the codebook's and smooth's gradients by `lut_codebook_grad`
    on x and smooth_p (it splits Xs_p = x / smooth_p itself). Gradients are
    f32 inside and leave in their tensor's dtype."""

    @staticmethod
    def forward(ctx, x, packed, nbits, *fields):
        cbs, smooths = fields[0::2], fields[1::2]
        invs = [1.0 / s.to(torch.float32) for s in smooths]
        p = len(packed)
        if p == 1:
            ys = (lut_gemm_fused(x, invs[0], packed[0], cbs[0], 1.0, quantize=False,
                                 nbits=nbits[0]),)
        else:
            ys = lut_gemm_fused_multi(x, torch.stack(invs),
                                      torch.stack([pad_codebook(cb) for cb in cbs]),
                                      [1.0] * p, *packed, quantize=(False,) * p, nbits=nbits)
        ctx.save_for_backward(x, *fields)
        ctx.packed, ctx.nbits = packed, nbits
        return tuple(y.to(x.dtype) for y in ys)

    @staticmethod
    def backward(ctx, *dys):
        x, *fields = ctx.saved_tensors
        k = x.shape[1]
        xf = x.to(torch.float32)
        dx, grads = None, []
        for p, (dy, pk, nb) in enumerate(zip(dys, ctx.packed, ctx.nbits)):
            cb, s = fields[2 * p], fields[2 * p + 1]
            need_x = ctx.needs_input_grad[0]
            need_fields = ctx.needs_input_grad[3 + 2 * p] or ctx.needs_input_grad[4 + 2 * p]
            if not (need_x or need_fields):
                grads += [None, None]
                continue
            s32, dy = s.to(torch.float32), dy.to(torch.float32).contiguous()
            cb16, dy_split = pad_codebook(cb), split_bf16(dy)
            if need_x:
                part = lut_matmul_t(dy, pk, cb16, nbits=nb, dy_split=dy_split)[:, :k] / s32
                dx = part if dx is None else dx + part
            if need_fields:
                kc = padded_d_in(k, nb)
                dcb, dsm = lut_codebook_grad(
                    _pad_k(xf, nb), dy, pk, cb16, F.pad(s32, (0, kc - k), value=1.0),
                    nbits=nb, dy_split=dy_split)
                grads += [dcb[:cb.shape[0]].to(cb.dtype), dsm[:k].to(s.dtype)]
            else:
                grads += [None, None]
        return (None if dx is None else dx.to(x.dtype), None, None, *grads)


def _grad_route(x: torch.Tensor, cts) -> Tuple[torch.Tensor, ...]:
    """The differentiable route: `clustered_matmul` per projection on the
    CPU (autograd differentiates it), `_LutProjections` on the card."""
    if not _reaches_kernel(x):
        return tuple(clustered_matmul(x, ct) for ct in cts)
    lead = x.shape[:-1]
    fields = [f for ct in cts for f in (ct.codebook, ct.smooth)]
    ys = _LutProjections.apply(x.reshape(-1, x.shape[-1]), tuple(packed_view(ct) for ct in cts),
                               tuple(ct.nbits for ct in cts), *fields)
    return tuple(y.reshape(*lead, -1) for y in ys)


def clustered_linear(x: torch.Tensor, ct: ClusteredTensor) -> torch.Tensor:
    """Model-facing clustered matmul: the fused LUT contraction over the
    tensor's packed codes, cast back to x's dtype. `ct` is one layer's
    tensor with one codebook: stacked (expert) codebooks never come here,
    as in the JAX package's models - `models/layers.py moe_block` resolves
    them through `layers.resolve_weight`. A call that autograd would
    differentiate takes the reference's float route (`_grad_route`)."""
    if ct.codebook.ndim != 1:
        raise NotImplementedError(
            f"clustered_linear: stacked codebook {tuple(ct.codebook.shape)}; "
            f"stacked experts are resolved by models/layers.py resolve_weight "
            f"(moe_block's route), and a stacked layer axis is indexed first")
    if _needs_grad(x, (ct,)):
        return _grad_route(x, (ct,))[0]
    inv, act, quantize = _transform_params(ct)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = lut_gemm_fused(x2, inv, packed_view(ct), ct.codebook, act,
                       quantize=quantize, nbits=ct.nbits)
    return y.reshape(*lead, -1).to(x.dtype)


def lut_gemm_fused_multi(
    x: torch.Tensor,            # (M, K) RAW activations shared by P projections
    inv_stack: torch.Tensor,    # (P, K) f32 — per-projection Eq. 11 multipliers
    cb_stack: torch.Tensor,     # (P, KC) f32 — padded codebooks
    act_stack: Sequence,        # P scalars s_q (1.0 where unused)
    *packed_list: torch.Tensor, # P × (packed_rows(K, nbits_p), n_p) uint8
    quantize: Tuple[bool, ...],
    nbits: Tuple[int, ...],
) -> Tuple[torch.Tensor, ...]:
    """Single-launch multi-projection serving GEMM: every projection's
    smooth(+quant) and LUT contraction in ONE kernel over the shared input.
    Returns P (M, n_p) outputs, each the same bits as `lut_gemm_fused` on that
    projection's operands: the kernels sum K in one order whatever the tile
    widths, so, unlike the JAX package, no width-agreement rule applies.

    K pads to the widest packing group of the set; a projection whose packed
    codes cover fewer rows (a 4-bit one beside a 3-bit one, K not a multiple
    of 8) gets zero-code rows, which meet zero activations."""
    m, k = x.shape
    kc = max(padded_d_in(k, nb) for nb in nbits)
    inv_stack = inv_stack.to(torch.float32)
    if kc != k:
        x = F.pad(x, (0, kc - k))
        inv_stack = F.pad(inv_stack, (0, kc - k))
    packed_list = [
        pk if pk.shape[0] == kc * nb // 8 else F.pad(pk, (0, 0, 0, kc * nb // 8 - pk.shape[0]))
        for pk, nb in zip(packed_list, nbits)]
    kern = lut_matmul_fused_multi_gemv if m < GEMV_MAX_M else lut_matmul_fused_multi
    y = kern(x.contiguous(), inv_stack.contiguous(), cb_stack.contiguous(),
             *packed_list, quantize=tuple(quantize), nbits=tuple(nbits))
    outs, off = [], 0
    for pk, act, qz in zip(packed_list, act_stack, quantize):
        seg = y[:, off:off + pk.shape[1]]
        outs.append(seg * act if qz else seg)
        off += pk.shape[1]
    return tuple(outs)


def clustered_linear_multi(x: torch.Tensor, cts) -> Tuple[torch.Tensor, ...]:
    """Model-facing MULTI-projection clustered matmul: P projections sharing
    the input x (QKV; gate+up) served by ONE kernel launch. Returns a tuple of
    P outputs, each the same bits as `clustered_linear(x, ct)`; per-projection
    nbits and quantize flags may differ.

    A single projection, or a stacked (expert) codebook, goes through
    per-projection `clustered_linear` calls. A call that autograd would
    differentiate takes the reference's float route, one B3 / B4 launch
    forward on the card (`_grad_route`)."""
    cts = tuple(cts)
    if len(cts) < 2 or any(ct.codebook.ndim != 1 for ct in cts):
        return tuple(clustered_linear(x, ct) for ct in cts)
    if _needs_grad(x, cts):
        return _grad_route(x, cts)
    params = [_transform_params(ct) for ct in cts]
    lead = x.shape[:-1]
    ys = lut_gemm_fused_multi(
        x.reshape(-1, x.shape[-1]), torch.stack([inv for inv, _, _ in params]),
        torch.stack([pad_codebook(ct.codebook) for ct in cts]),
        [act for _, act, _ in params], *[packed_view(ct) for ct in cts],
        quantize=tuple(qz for _, _, qz in params),
        nbits=tuple(ct.nbits for ct in cts))
    return tuple(y.reshape(*lead, -1).to(x.dtype) for y in ys)
