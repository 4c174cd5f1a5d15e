"""Model-level LCD API: ClusteredTensor params + compress_model — the port of
the JAX package's `repro.core.api`.

A `ClusteredTensor` is the framework representation of an LCD-compressed
weight: centroid codes (packed at 2/3/4 bits per code for serving), a tiny
codebook, and the folded smoothing vector.

`compress_model` runs the paper's pipeline over a whole parameter tree
(nested dicts of tensors):
  1. optional calibration backward passes -> empirical-Fisher diag Hessian
     (`torch.autograd.grad` over the float leaves);
  2. adaptive smoothing per eligible layer from captured input absmax (Eq. 9);
  3. DBCI + progressive/speculative distillation per layer (§3.1-3.3), on
     the weight's device;
  4. emits ClusteredTensors + a per-layer report (centroid counts, objectives,
     the per-layer packing widths).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import clustering as C
from repro_torch.core.distill import (DistillReport, LCDConfig, distill_layer,
                                      distill_layer_to_k)
from repro_torch.core.lut import (SUPPORTED_NBITS, pack_codes, pack_codes_torch,
                                  unpack_codes)
from repro_torch.core.smoothing import adaptive_smooth, fold_into_weight
from repro_torch.optim.compress import allocate_bits
from repro_torch.tree import dict_key, flatten_with_paths
from repro_torch.utils import logger, resolve_device


class ClusteredTensor(NamedTuple):
    """LCD-compressed linear weight. Logical value = codebook[codes] / smooth[:, None]
    applied as (x / smooth) @ codebook[codes] — see clustered_matmul.

    Serving artifacts are first-class fields, computed once when the tensor is
    assembled:

      packed    — sub-byte packed codes along d_in at `nbits` per code
                  (2 codes/byte at 4-bit, 8 codes in 3 bytes at 3-bit,
                  4 codes/byte at 2-bit); what the serving kernel streams.
      inv_scale — the Eq. 11 fused multiplier 1/(s_m·s_q) per input channel
                  (1/s_m when no activation scale is calibrated).
      act_scale — s_q, the symmetric int8 scale of the smoothed activations;
                  None means "not calibrated": the serving kernel then runs
                  its float variant (smoothing folded, no quantization).

    `nbits` is the tensor's packing width, a plain Python int. Stacked
    per-layer tensors carry a leading layer axis on every array field.
    """
    codes: torch.Tensor                        # (d_in, d_out) int8, or packed uint8
    codebook: torch.Tensor                     # (K,) f32 centroids of the smoothed weight
    smooth: torch.Tensor                       # (d_in,) f32 smoothing vector
    packed: Optional[torch.Tensor] = None      # (packed_rows(d_in, nbits), d_out) uint8
    inv_scale: Optional[torch.Tensor] = None   # (d_in,) f32 = 1/(s_m·s_q)
    act_scale: Optional[torch.Tensor] = None   # () f32 s_q; None = uncalibrated
    nbits: int = 4                             # packing width in {2, 3, 4}

    @property
    def shape(self):
        return self.codes.shape

    @property
    def n_centroids(self) -> int:
        return int(self.codebook.shape[-1])


CT_ARRAY_FIELDS = ("codes", "codebook", "smooth", "packed", "inv_scale",
                   "act_scale")


def is_clustered(x: Any) -> bool:
    return isinstance(x, ClusteredTensor)


def map_arrays(ct: ClusteredTensor, fn) -> ClusteredTensor:
    """Apply `fn` to every array field that is present; `nbits` and the
    `None`s pass through."""
    return ct._replace(**{
        f: fn(getattr(ct, f)) for f in CT_ARRAY_FIELDS
        if getattr(ct, f) is not None})


def _unpack_codes(codes: torch.Tensor, d_in: int, nbits: int = 4) -> torch.Tensor:
    """Unpack sub-byte codes along axis -2 when codes are stored packed
    ((..., packed_rows, d_out) uint8 -> (..., d_in, d_out) int32). Codes
    already at full d_in rows pass through as int32."""
    if codes.shape[-2] == d_in:
        return codes.to(torch.int32)
    return unpack_codes(codes, d_in, nbits)


def clustered_dequant(ct: ClusteredTensor) -> torch.Tensor:
    """Dense equivalent weight W = diag(1/s) @ codebook[codes] (f32)."""
    d_in = ct.smooth.shape[-1]
    w_s = ct.codebook[_unpack_codes(ct.codes, d_in, ct.nbits).long()]
    return w_s / ct.smooth[:, None]


def clustered_matmul(x: torch.Tensor, ct: ClusteredTensor, *,
                     dtype=None) -> torch.Tensor:
    """x @ W via the smoothed factorization: (x / s) @ codebook[codes].
    Codes may be packed (nbits codes per 8 bits along d_in)."""
    dtype = dtype or x.dtype
    d_in = ct.smooth.shape[-1]
    w_s = ct.codebook[_unpack_codes(ct.codes, d_in, ct.nbits).long()].to(dtype)
    xs = x / ct.smooth.to(x.dtype)
    return xs @ w_s


def dense_to_clustered(w, codes, codebook: np.ndarray,
                       smooth: Optional[np.ndarray] = None,
                       act_scale: Optional[float] = None,
                       nbits: int = 4, device="cuda") -> ClusteredTensor:
    """Assemble a ClusteredTensor with its serving artifacts precomputed:
    packed sub-byte codes (at `nbits` per code) and the Eq. 11 inv_scale
    (once, here — never per call on the serving path). numpy codes are
    packed on the host and moved to `device`; tensor codes are packed where
    they lie, and the tensor lands there."""
    if codebook.shape[-1] > (1 << nbits):
        raise ValueError(
            f"{codebook.shape[-1]} centroids do not fit {nbits}-bit codes "
            f"(max {1 << nbits})")
    d_in = w.shape[0]
    s = np.ones((d_in,), np.float32) if smooth is None else np.asarray(smooth, np.float32)
    sq = 1.0 if act_scale is None else float(act_scale)

    if isinstance(codes, torch.Tensor):
        device = codes.device
        codes_t = codes.to(torch.int8)
        packed = pack_codes_torch(codes, nbits)
    else:
        device = resolve_device(device)
        codes_t = torch.from_numpy(codes.astype(np.int8)).to(device)
        packed = torch.from_numpy(pack_codes(codes.astype(np.uint8), nbits)).to(device)

    def dev(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return ClusteredTensor(
        codes=codes_t,
        codebook=dev(np.asarray(codebook, np.float32)),
        smooth=dev(s),
        packed=packed,
        inv_scale=dev((1.0 / (s * sq)).astype(np.float32)),
        act_scale=None if act_scale is None else dev(np.float32(act_scale)),
        nbits=nbits,
    )


# ---------------------------------------------------------------------------
# Eligibility: which parameters get clustered
# ---------------------------------------------------------------------------

# path-regexes NEVER clustered: embeddings, norms, biases, router/gates, SSM/RWKV
# dynamics parameters (they feed exponentials), small vectors.
_EXCLUDE = re.compile(
    r"(embed|embedding|lm_head|norm|scale|bias|router|gate_w|a_log|dt_|decay|"
    r"time_|lerp|conv|state|\['b[a-z_]*'\]$|\['u'\]$)", re.I,
)


def default_predicate(path: str, x: Any) -> bool:
    if not isinstance(x, (np.ndarray, torch.Tensor)) and not hasattr(x, "shape"):
        return False
    if getattr(x, "ndim", 0) not in (2, 3):
        return False  # 3-D = stacked (L, d_in, d_out): per-slice LCD
    if min(x.shape[-2:]) < 32:           # tiny matrices: not worth it
        return False
    if _EXCLUDE.search(path):
        return False
    return True


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a parameter tree (nested dicts) in the
    reference's order and spelling (`repro_torch.tree`): keys sorted, a path
    reads "['a']['b']"; everything but a dict, a ClusteredTensor too, is one
    leaf."""
    return flatten_with_paths(tree, prefix, is_leaf=lambda n: not isinstance(n, dict))


def _rebuild(tree, leaves: Dict[str, Any], prefix: str = ""):
    """`tree` with the leaf at each path replaced by leaves[path]."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + dict_key(k)) for k, v in tree.items()}
    return leaves[prefix]


@dataclasses.dataclass
class CompressReport:
    per_layer: Dict[str, DistillReport]
    smoothing: Dict[str, str]                    # layer -> chosen smoothing kind
    centroid_counts: Dict[str, int]
    equivalent_bits: float                       # average log2(K) over clustered params
    params_clustered: int
    params_total: int
    # per-layer packing width — what the serving stream pays per weight, as
    # opposed to equivalent_bits (log2 K, the information content). Uniform
    # runs record the same value everywhere; bits_budget runs record the
    # Fisher-scored assignment.
    bits_assignment: Dict[str, int] = dataclasses.field(default_factory=dict)
    bits_budget: Optional[float] = None          # requested global mean; None = uniform
    mean_packed_bits: float = 4.0                # element-weighted mean of the widths

    def summary(self) -> str:
        ks = list(self.centroid_counts.values())
        mix: Dict[int, int] = {}
        for b in self.bits_assignment.values():
            mix[b] = mix.get(b, 0) + 1
        mix_s = "/".join(f"{mix.get(b, 0)}x{b}b" for b in sorted(mix))
        return (
            f"clustered {len(ks)} tensors | centroids min/avg/max = "
            f"{min(ks)}/{np.mean(ks):.1f}/{max(ks)} | equiv bits = {self.equivalent_bits:.2f} "
            f"| packed bits = {self.mean_packed_bits:.2f} ({mix_s})"
            f"{f' <= budget {self.bits_budget:g}' if self.bits_budget else ''}"
            f" | coverage = {self.params_clustered / max(self.params_total, 1):.1%}"
        )

    def bits_table(self) -> str:
        """Per-layer deployment inventory: path, packing width, centroid
        count — what `launch/serve.py --describe` prints."""
        if not self.bits_assignment:
            return "(no clustered tensors)"
        width = max(len(p) for p in self.bits_assignment)
        lines = [f"{'layer':<{width}}  bits  K"]
        for p in sorted(self.bits_assignment):
            lines.append(f"{p:<{width}}  {self.bits_assignment[p]:>4}  "
                         f"{self.centroid_counts.get(p, '?')}")
        lines.append(f"mean packed bits = {self.mean_packed_bits:.2f}"
                     + (f" (budget {self.bits_budget:g})"
                        if self.bits_budget else " (uniform)"))
        return "\n".join(lines)


def _fisher(params, leaves, loss_fn, calib_batches) -> Dict[str, torch.Tensor]:
    """E[g^2] per float leaf over the calibration batches, g the gradient of
    loss_fn(params, batch) by `torch.autograd.grad` (zeros for a leaf the
    loss does not use)."""
    floats = [(p, x) for p, x in leaves
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    acc = None
    for b in calib_batches:
        var = {p: x.detach().requires_grad_(True) for p, x in floats}
        loss = loss_fn(_rebuild(params, {**dict(leaves), **var}), b)
        grads = torch.autograd.grad(loss, list(var.values()), allow_unused=True)
        sq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) if g is None
              else g.detach().to(torch.float32) ** 2 for (_, x), g in zip(floats, grads)]
        acc = sq if acc is None else [a + q for a, q in zip(acc, sq)]
    n = len(calib_batches)
    return {p: a / n for (p, _), a in zip(floats, acc)}


def compress_model(
    params,
    *,
    loss_fn: Optional[Callable] = None,          # loss_fn(params, batch) -> scalar tensor
    calib_batches: Optional[List[Any]] = None,
    cfg: LCDConfig = LCDConfig(),
    target_centroids: int = 0,                   # 0 = adaptive (layer-wise dynamic, Fig. 8)
    predicate: Callable[[str, Any], bool] = default_predicate,
    smooth_amax: Optional[Dict[str, np.ndarray]] = None,  # per-layer input absmax (optional)
    nbits: int = 4,                              # uniform packing width
    bits_budget: Optional[float] = None,         # global mean-bits cap -> mixed precision
    device="cuda",
) -> Tuple[Any, CompressReport]:
    """Run LCD over every eligible weight in `params` (nested dicts of
    tensors). Each weight is compressed on its own device and its
    ClusteredTensor lands there; a numpy leaf goes to `device` (the card
    unless the caller asks for the CPU).

    If loss_fn+calib_batches are given, the diag Hessian is the empirical Fisher
    accumulated over the calibration batches; otherwise H = 1 (pure geometric
    clustering — unit tests and fast smoke paths).

    Bit-width policy: `nbits` sets a uniform packing width (codes per layer
    are capped at 2**nbits centroids and packed at that width). `bits_budget`
    instead assigns widths PER LAYER under a global element-weighted mean-bits
    cap: each layer is scored by its empirical-Fisher quantization
    sensitivity mean(H·w²), and `optim/compress.py allocate_bits` demotes the
    least-sensitive layers from 4 → 3 → 2 bits until the budget holds.
    """
    if nbits not in SUPPORTED_NBITS:
        raise ValueError(f"nbits must be one of {SUPPORTED_NBITS}; got {nbits}")
    if bits_budget is not None and not (
            min(SUPPORTED_NBITS) <= bits_budget <= max(SUPPORTED_NBITS)):
        raise ValueError(
            f"bits_budget must lie in [{min(SUPPORTED_NBITS)}, "
            f"{max(SUPPORTED_NBITS)}]; got {bits_budget}")
    leaves = _flatten_with_paths(params)
    eligible = {p for p, x in leaves if predicate(p, x)}

    # --- 1. Fisher diag over calibration data --------------------------------
    fisher = None
    if loss_fn is not None and calib_batches:
        fisher = _fisher(params, leaves, loss_fn, calib_batches)

    def _weight(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.detach().to(torch.float32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(resolve_device(device))

    def _hessian_of(path, w):
        if fisher is not None and path in fisher:
            # the reference's damping, in numpy float32 on the host
            h = fisher[path].cpu().numpy().astype(np.float32).reshape(tuple(w.shape))
            return torch.from_numpy(h + 1e-2 * h.mean() + 1e-12).to(w.device)
        return torch.ones_like(w)

    # --- 1b. per-layer bit-width assignment ----------------------------------
    if bits_budget is not None:
        scores: Dict[str, float] = {}
        sizes: Dict[str, int] = {}
        for p, x in leaves:
            if p not in eligible:
                continue
            w = _weight(x)
            # second-order quantization sensitivity: E[H · w²]
            scores[p] = float(torch.mean(_hessian_of(p, w) * w ** 2))
            sizes[p] = int(w.numel())
        bits_map = allocate_bits(scores, sizes, bits_budget)
    else:
        bits_map = {p: nbits for p in eligible}

    # --- 2+3. per-layer smoothing + distillation -----------------------------
    per_layer: Dict[str, DistillReport] = {}
    smoothing: Dict[str, str] = {}
    counts: Dict[str, int] = {}
    bits_assignment: Dict[str, int] = {}
    elem_bits: Dict[str, int] = {}               # path -> elements * width
    n_clustered = 0
    n_total = 0

    def _one_slice(w2, h2, s, k_target):
        """LCD on a single (d_in, d_out) matrix. Returns (codes, centroids, rep)."""
        w_s = fold_into_weight(w2, s)
        if k_target:
            codes, state, rep = distill_layer_to_k(w_s, h2, k_target, cfg)
        else:
            codes, state, rep = distill_layer(w_s, h2, cfg)
        cents = rep.final_centroids
        # re-index codes from K_MAX slot indices onto the compact centroid set
        lut = np.zeros(C.K_MAX, np.int32)
        for j, a in enumerate(np.where(state.active.cpu().numpy())[0]):
            lut[a] = j
        lut_t = torch.from_numpy(lut).to(codes.device)
        return lut_t.index_select(0, codes.reshape(-1)).reshape(codes.shape), cents, rep

    def process(path, x):
        nonlocal n_clustered, n_total
        n_total += int(np.prod(x.shape)) if hasattr(x, "shape") else 0
        if path not in eligible:
            return x
        w = _weight(x)

        # smoothing (needs input absmax; falls back to identity otherwise).
        # A calibrated smoothing also yields s_q, which arms the serving
        # kernel's int8 Eq. 11 path; identity leaves act_scale=None so serving
        # runs the float transform (no made-up quant scale).
        if smooth_amax and path in smooth_amax:
            sres = adaptive_smooth(smooth_amax[path][None, :])
            s = sres.s
            act_scale = sres.act_scale
            smoothing[path] = sres.kind
        else:
            s = np.ones((w.shape[-2],), np.float32)
            act_scale = None
            smoothing[path] = "identity"

        h = _hessian_of(path, w)

        # the layer's packing width caps its centroid count: K <= 2**bits.
        # Sub-4-bit layers always distill to exactly 2**bits; 4-bit keeps the
        # adaptive behavior when no explicit target is set.
        layer_bits = bits_map.get(path, nbits)
        kcap = 1 << layer_bits
        if target_centroids:
            k_target = min(target_centroids, kcap)
        elif layer_bits < 4:
            k_target = kcap
        else:
            k_target = 0

        if w.ndim == 2:
            codes, cents, rep = _one_slice(w, h, s, k_target)
            counts[path] = len(cents)
            per_layer[path] = rep
            ct = dense_to_clustered(w, codes, cents, smooth=s,
                                    act_scale=act_scale, nbits=layer_bits)
        else:
            # stacked (L, d_in, d_out): per-slice LCD — the paper's layer-wise
            # dynamic centroid allocation (Fig. 8). Codebooks pad to the max K
            # across slices (padded entries duplicate the last centroid; no
            # code references them).
            slices = [_one_slice(w[l], h[l], s, k_target) for l in range(w.shape[0])]
            kmax = max(len(c) for _, c, _ in slices)
            codes = torch.stack([cd for cd, _, _ in slices])
            cbs = np.stack([np.pad(c, (0, kmax - len(c)), mode="edge")
                            for _, c, _ in slices])
            counts[path] = int(round(float(np.mean(
                [len(c) for _, c, _ in slices]))))
            per_layer[path] = slices[0][2]
            for l, (_, c, rep_l) in enumerate(slices):
                per_layer[f"{path}[{l}]"] = rep_l
            sq = 1.0 if act_scale is None else float(act_scale)
            s_full = np.broadcast_to(s, (w.shape[0], w.shape[1])).copy()
            dev = w.device
            ct = ClusteredTensor(
                codes=codes.to(torch.int8),
                codebook=torch.from_numpy(cbs.astype(np.float32)).to(dev),
                smooth=torch.from_numpy(s_full).to(dev),
                packed=torch.stack([pack_codes_torch(codes[l], layer_bits)
                                    for l in range(codes.shape[0])]),
                inv_scale=torch.from_numpy((1.0 / (s_full * sq)).astype(np.float32)).to(dev),
                # a leading L axis, sliced per layer with the other fields
                act_scale=None if act_scale is None else torch.full(
                    (w.shape[0],), act_scale, dtype=torch.float32, device=dev),
                nbits=layer_bits,
            )
        bits_assignment[path] = layer_bits
        elem_bits[path] = w.numel() * layer_bits
        n_clustered += w.numel()
        logger.info(f"LCD {path}: {tuple(w.shape)} -> K={counts[path]} "
                    f"bits={layer_bits} smooth={smoothing[path]}")
        return ct

    new_leaves = {p: process(p, x) for p, x in leaves}
    new_params = _rebuild(params, new_leaves)

    ks = list(counts.values()) or [0]
    report = CompressReport(
        per_layer=per_layer,
        smoothing=smoothing,
        centroid_counts=counts,
        equivalent_bits=float(np.mean([np.log2(max(k, 1)) for k in ks])),
        params_clustered=n_clustered,
        params_total=n_total,
        bits_assignment=bits_assignment,
        bits_budget=bits_budget,
        mean_packed_bits=(sum(elem_bits.values()) / max(n_clustered, 1)
                          if bits_assignment else float(nbits)),
    )
    if counts:
        logger.info("compress_model: " + report.summary())
    return new_params, report
