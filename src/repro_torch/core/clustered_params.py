"""ClusteredTensor parameter trees for LCD serving without a compression run,
plus the 2-bit draft clustering used for self-speculative decoding.

For smoke tests of the serve path we need the *shape* of an LCD-compressed
model without running distillation on it: this module maps a model's
parameter table to the equivalent ClusteredTensor tree (sub-byte packed codes
+ codebook + smoothing vector per eligible weight) and fills it with
random-but-valid values. `packed_weight_bytes` counts what a clustered tree
streams.

`make_draft_params` builds the serving engine's speculative draft: the
model's OWN weights clustered down to 4 centroids and packed at true 2 bits
(half the stream bytes of the int4 layout), so the draft costs no extra
training and no second checkpoint.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.api import (ClusteredTensor, _unpack_codes, compress_model,
                                  default_predicate, is_clustered)
from repro_torch.core.lut import _check_nbits, packed_rows
from repro_torch.models import params as PT
from repro_torch.models.registry import Model
from repro_torch.utils import resolve_device

KC = 16

# path-regexes NEVER clustered: embeddings, norms, biases, router/gates,
# SSM/RWKV dynamics parameters (they feed exponentials), small vectors.
_EXCLUDE = re.compile(
    r"(embed|embedding|lm_head|norm|scale|bias|router|gate_w|a_log|dt_|decay|"
    r"time_|lerp|conv|state|\['b[a-z_]*'\]$|\['u'\]$)", re.I,
)


def _eligible(path: str, decl: PT.ParamDecl) -> bool:
    # >=2D weight matrices, excluding embeddings/norms/routers/dynamics
    if len(decl.shape) < 2 or min(decl.shape[-2:]) < 32:
        return False
    # true weight matrices have >= 2 non-layer logical dims; stacked biases
    # ((L, dim), names "layers,x") do not
    dims = decl.names.split(",")
    non_layer = [d for d in dims if d not in ("layers",)]
    if len(non_layer) < 2:
        return False
    if _EXCLUDE.search(path):
        return False
    # skip tied/vocab tensors by name fragment
    if "embed" in path or "lm_head" in path or "pos" in path:
        return False
    return True


def clustered_abstract(model: Model, nbits: int = 4) -> Tuple[Any, Dict[str, int]]:
    """(shapes, stats): the model's parameter tree with every eligible dense
    weight replaced by a ClusteredTensor of SHAPES (codes stored packed at
    `nbits`, codebook, smooth) and every other leaf by its
    (shape, torch dtype); stats count tensors and bytes on both sides."""
    _check_nbits(nbits)
    dtype = model.cfg.torch_dtype
    stats = {"clustered": 0, "dense": 0, "code_bytes": 0, "dense_bytes": 0}

    def one(path: str, decl: PT.ParamDecl):
        if _eligible(path, decl):
            *lead, d_in, d_out = decl.shape
            codes_shape = tuple(lead) + (packed_rows(d_in, nbits), d_out)
            stats["clustered"] += 1
            stats["code_bytes"] += math.prod(codes_shape)
            return ClusteredTensor(codes=codes_shape,
                                   codebook=tuple(lead) + (KC,),
                                   smooth=tuple(lead) + (d_in,), nbits=nbits)
        dt = PT.decl_dtype(decl, dtype)
        stats["dense"] += 1
        stats["dense_bytes"] += math.prod(decl.shape) * dt.itemsize
        return (tuple(decl.shape), dt)

    return PT.map_table(model.table, one), stats


def materialize_clustered(model: Model, generator: torch.Generator,
                          nbits: int = 4, device="cuda") -> Any:
    """Random-but-valid clustered params (smoke tests of the serve path):
    random packed codes (uniform random bytes are valid bit-streams at every
    width — each sub-byte field lands in [0, 2**nbits)), sorted random
    codebook, unit smoothing; dense leaves are normal(0, 0.02). Numbers are
    drawn on the generator's device, leaf by leaf, and moved to `device`."""
    shapes, _ = clustered_abstract(model, nbits=nbits)
    device = resolve_device(device)
    gdev = generator.device

    def one(leaf):
        if is_clustered(leaf):
            codes = torch.randint(0, 255, leaf.codes, generator=generator,
                                  dtype=torch.uint8, device=gdev)
            cb = torch.sort(torch.randn(leaf.codebook, generator=generator,
                                        dtype=torch.float32, device=gdev) * 0.02,
                            dim=-1).values
            return ClusteredTensor(
                codes.to(device), cb.to(device),
                torch.ones(leaf.smooth, dtype=torch.float32, device=device),
                nbits=leaf.nbits)
        shape, dt = leaf
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=gdev)
        return (x * 0.02).to(dt).to(device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return one(tree)

    return walk(shapes)


# ---------------------------------------------------------------------------
# Self-speculative draft clustering
# ---------------------------------------------------------------------------

def _dequantize_leaf(ct: ClusteredTensor) -> torch.Tensor:
    """Dense f32 W = codebook[codes] / smooth of one (possibly stacked)
    clustered leaf, on its device, one (d_in, d_out) slice at a time so that
    only one slice's int64 gather index is alive at once."""
    d_in, d_out = ct.smooth.shape[-1], ct.codes.shape[-1]
    lead = tuple(ct.smooth.shape[:-1])
    codes = ct.codes.reshape((-1,) + tuple(ct.codes.shape[-2:]))
    cbs = ct.codebook.reshape(-1, ct.codebook.shape[-1])
    smooth = ct.smooth.reshape(-1, d_in)
    out = torch.empty((codes.shape[0], d_in, d_out), dtype=torch.float32,
                      device=ct.codebook.device)
    for i in range(codes.shape[0]):
        idx = _unpack_codes(codes[i], d_in, ct.nbits).long()
        cb = cbs[0] if ct.codebook.ndim == 1 else cbs[i]
        torch.div(cb[idx], smooth[i][:, None], out=out[i])
    return out.reshape(lead + (d_in, d_out))


def dequantize_params(params) -> Any:
    """Replace every ClusteredTensor leaf with its dense f32 equivalent
    W = codebook[codes] / smooth (packed or full-row codes, stacked (L, ...)
    leaves with per-slice codebooks). Dense leaves pass through untouched;
    each dense leaf is made on its ClusteredTensor's device."""
    if isinstance(params, dict):
        return {k: dequantize_params(v) for k, v in params.items()}
    return _dequantize_leaf(params) if is_clustered(params) else params


def _clustered_leaves(tree):
    if isinstance(tree, dict):
        return [c for v in tree.values() for c in _clustered_leaves(v)]
    return [tree] if is_clustered(tree) else []


def make_draft_params(params, *, draft_centroids: int = 4,
                      predicate=default_predicate) -> Tuple[Any, Any]:
    """Extreme low-bit LCD draft of `params` for self-speculative decoding.

    The draft is the model's OWN weights re-clustered to `draft_centroids`
    (4 = 2 bits) and packed at the narrowest width that holds them
    (ceil(log2 K), floored at 2): no second checkpoint, no draft training,
    and at the default HALF the packed weight bytes of the int4 layout,
    checked below. If `params` is already LCD-compressed, clustered leaves
    are dequantized first, on their own device, so the draft tracks the
    weights the target serves. Embeddings, norms and the lm_head stay as
    they are (they are never clustered). Everything runs on the params'
    device; the dense copy is dropped as soon as the draft is built, and at
    no point are two dense copies alive.

    Returns (draft_params, CompressReport)."""
    draft_nbits = max(2, math.ceil(math.log2(max(draft_centroids, 2))))
    dense = dequantize_params(params)
    draft, report = compress_model(dense, target_centroids=draft_centroids,
                                   predicate=predicate, nbits=draft_nbits)
    del dense
    leaves = _clustered_leaves(draft)
    # postconditions (ValueError, not assert: python -O strips asserts):
    # every clustered leaf packed at the draft width — a fallback to a wider
    # layout would silently double the draft's stream
    for leaf in leaves:
        if leaf.nbits != draft_nbits:
            raise ValueError(
                f"draft leaf packed at {leaf.nbits}-bit; expected "
                f"{draft_nbits}-bit for draft_centroids={draft_centroids}")
    if draft_nbits == 2:
        got = packed_weight_bytes(draft)
        int4 = packed_weight_bytes(draft, nbits=4)
        # <= half the int4 stream, up to one byte-row of group padding per
        # tensor (a layer with d_in % 4 in {1, 2} packs a final partial
        # group the int4 layout does not pay for)
        slack = sum(math.prod(leaf.codes.shape[:-2]) * leaf.codes.shape[-1]
                    for leaf in leaves)
        if got * 2 > int4 + slack:
            raise ValueError(
                f"2-bit draft must stream ≤ half the int4 weight bytes; "
                f"got {got} vs int4 {int4} (+{slack} group-padding slack)")
    return draft, report


def packed_weight_bytes(params, nbits: Optional[int] = None) -> int:
    """Total serving-stream bytes of every clustered leaf's packed codes —
    the operand the decode GEMV reads from device memory. With `nbits`
    given, the byte count of repacking the same codes at that width."""
    if isinstance(params, dict):
        return sum(packed_weight_bytes(v, nbits) for v in params.values())
    if not is_clustered(params):
        return 0
    d_in, d_out = params.smooth.shape[-1], params.codes.shape[-1]
    lead = math.prod(params.codes.shape[:-2])
    return lead * packed_rows(d_in, params.nbits if nbits is None else nbits) * d_out
