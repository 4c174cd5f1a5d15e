"""Clustering primitives for LCD (paper §3.1) — the port of the JAX package's
`repro.core.clustering`.

DBCI (Density-Based Centroid Initialization) runs on the host in numpy, as in
the reference: LLM weights are scalars, so DBSCAN over a weight tensor is a
1-D problem that is exact and linear-time on sorted data. Only its subsample
(at most 2^17 weights, chosen by the reference's own generator) leaves the
device. `kmeans_1d` and `uniform_grid_centroids` are the reference's numpy
baselines; `kmeans_1d` also takes a tensor and then runs on its device.

The cluster state the distillation loop works on is a fixed-size (K_MAX)
`ClusterState` of tensors on the weight's device, and every state operation
(`assign`, `dequant`, `objective`, `refresh`, `merge_closest`) is plain
PyTorch there. Two things keep it equal to the reference:

  * `assign` compares |w - c| for every candidate centroid and keeps the
    first minimum (argmin's tie rule), row chunk by row chunk so that the
    (weights x centroids) distance table never outgrows a few hundred MB;
  * `refresh` sums each cluster's mass in one fixed order: on the CPU the
    sequential scatter-add the reference's `.at[].add` performs (bit-equal),
    on the card masked `torch.sum`s, so that two runs on the same card give
    the same centroids (a scatter-add's atomics would not).

Where XLA on the CPU fuses a multiply into an add (the Eq. 5 update at
eta != 1 and the Eq. 8 merge), the port computes the fused form in float64
and rounds once, so the CPU results are the reference's bits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import resolve_device

# Maximum number of centroids the fixed-size cluster state can hold. DBCI
# empirically yields 15-20 (paper §3.1); 32 leaves headroom for speculative
# re-initialisation at larger eps.
K_MAX = 32

# bytes of one chunk of the (weights x centroids) f32 distance table
_CHUNK_BYTES = 1 << 28


# ---------------------------------------------------------------------------
# DBCI — Density-Based Centroid Initialization (paper §3.1, steps 1-6)
# ---------------------------------------------------------------------------

def estimate_sigma(w_sorted: np.ndarray) -> float:
    """Paper Eq. (1): sigma from the +-68.27/95.44/99.74 percentile weights.

    For a centred Gaussian the weight at the q-th percentile of the positive tail
    sits at k*sigma for k=1,2,3, so (sum of the six |values|)/12 estimates sigma
    robustly even with outliers (which only perturb the 3-sigma terms).
    """
    n = w_sorted.shape[0]

    def at(frac: float) -> float:
        idx = min(max(int(round(frac * (n - 1))), 0), n - 1)
        return float(w_sorted[idx])

    # percentile of the *signed* distribution corresponding to +-k sigma
    # (CDF of N(0,1) at +-1/2/3 sigma).
    pos = [at(0.84135), at(0.97725), at(0.99865)]   # +1, +2, +3 sigma
    neg = [at(0.15865), at(0.02275), at(0.00135)]   # -1, -2, -3 sigma
    sigma = (sum(pos) - sum(neg)) / 12.0
    return max(sigma, 1e-12)


@dataclasses.dataclass
class DBCIResult:
    centroids: np.ndarray          # (k,) sorted float32 centroids
    eps: float
    min_pts: int
    sigma: float
    n_noise: int                   # points labelled noise (absorbed post-hoc)


def _dbscan_1d_sorted(ws: np.ndarray, eps: float, min_pts: int) -> Tuple[np.ndarray, int]:
    """Exact DBSCAN on sorted 1-D data.

    Returns (cluster_id per point, with -1 = noise, ids contiguous from 0), n_clusters.
    A point is core iff #points within [w-eps, w+eps] >= min_pts; clusters are
    maximal runs of points chained through core points within eps.
    """
    n = ws.shape[0]
    lo = np.searchsorted(ws, ws - eps, side="left")
    hi = np.searchsorted(ws, ws + eps, side="right")
    core = (hi - lo) >= min_pts

    labels = np.full(n, -1, dtype=np.int64)
    cid = -1
    i = 0
    while i < n:
        if not core[i]:
            i += 1
            continue
        # start a new cluster at core point i; extend right while the chain holds
        cid += 1
        j = i
        labels[i] = cid
        # border points to the left of the first core point of the run
        k = i - 1
        while k >= 0 and labels[k] == -1 and ws[i] - ws[k] <= eps:
            labels[k] = cid
            k -= 1
        while j + 1 < n:
            if ws[j + 1] - ws[j] <= eps and (core[j] or core[j + 1]):
                j += 1
                labels[j] = cid
            else:
                break
        i = j + 1
    return labels, cid + 1


def _host_sample(w, subsample: int, seed: int) -> np.ndarray:
    """The finite weights DBCI sees, as float64 on the host: all of them, or
    `subsample` of them chosen exactly as the reference chooses (the same
    generator draws the same indices). A tensor stays on its device; only
    the chosen weights are copied to the host."""
    if not isinstance(w, torch.Tensor):
        flat = np.asarray(w, dtype=np.float64).reshape(-1)
        flat = flat[np.isfinite(flat)]
        if flat.size > subsample:
            flat = np.random.default_rng(seed).choice(flat, size=subsample, replace=False)
        return flat
    flat = w.detach().reshape(-1)
    if not bool(torch.isfinite(flat).all()):
        flat = flat[torch.isfinite(flat)]
    n = flat.numel()
    if n > subsample:
        idx = np.random.default_rng(seed).choice(n, size=subsample, replace=False)
        flat = flat[torch.from_numpy(idx).to(flat.device)]
    return flat.cpu().numpy().astype(np.float64)


def dbci_init(
    w,
    *,
    max_centroids: int = 20,
    min_centroids: int = 2,
    subsample: int = 1 << 17,
    eps_scale: float = 1.0,
    seed: int = 0,
) -> DBCIResult:
    """Density-Based Centroid Initialization (paper §3.1). `w` is a numpy
    array or a tensor on any device.

    eps_scale multiplies the derived eps — the speculative optimizer (paper §3.3)
    re-enters with eps_scale=2.0 then 1.5.
    """
    flat = _host_sample(w, subsample, seed)
    if flat.size == 0:
        raise ValueError("dbci_init: empty/namid weight tensor")
    ws = np.sort(flat)
    n = ws.shape[0]

    # Steps 1-2: sigma from percentiles.
    sigma = estimate_sigma(ws)

    # Step 3: the two most extreme points seed sigma-radius core neighbourhoods.
    lo_cnt = int(np.searchsorted(ws, ws[0] + sigma, side="right"))
    hi_cnt = int(n - np.searchsorted(ws, ws[-1] - sigma, side="left"))

    # Step 4: MinPts = smaller count; eps = sigma / MinPts.
    min_pts = max(int(min(lo_cnt, hi_cnt)), 2)
    eps = eps_scale * sigma / min_pts
    # Guard: for near-degenerate layers eps can underflow the float grid.
    eps = max(eps, 1e-9 * max(abs(float(ws[0])), abs(float(ws[-1])), 1e-30))

    # Step 5: standard DBSCAN on the (sorted) points.
    labels, k = _dbscan_1d_sorted(ws, eps, min_pts)

    # Adaptive guard: if eps over-segments far beyond the budget, widen it.
    tries = 0
    while k > 4 * max_centroids and tries < 40:
        eps *= 1.6
        labels, k = _dbscan_1d_sorted(ws, eps, min_pts)
        tries += 1

    # Step 6 (budgeted): the centroid budget is spread across the density
    # regions in proportion to their mass, each region's centroids at its
    # within-region quantile medians (see the reference for the rationale).
    n_noise = int((labels == -1).sum())
    budget = max(min_centroids, int(round(max_centroids / eps_scale)))
    regions: list[np.ndarray] = [ws[labels == c] for c in range(k)]
    if n_noise:
        noise = ws[labels == -1]
        regions.append(noise)
    regions = [r for r in regions if r.size > 0]
    if not regions:
        regions = [ws]
    masses = np.array([r.size for r in regions], np.float64)
    # proportional allocation, >=1 each, largest-remainder rounding
    raw = masses / masses.sum() * budget
    alloc = np.maximum(np.floor(raw).astype(int), 1)
    while alloc.sum() > budget and (alloc > 1).any():
        alloc[np.argmax(alloc - raw)] -= 1
    rem = budget - alloc.sum()
    if rem > 0:
        order = np.argsort(-(raw - alloc))
        for i in order[:rem]:
            alloc[i] += 1
    cents_list = []
    for r, m in zip(regions, alloc):
        m = min(int(m), r.size)
        qs = (np.arange(m) + 0.5) / m
        cents_list.append(np.quantile(r, qs))
    cents = np.unique(np.concatenate(cents_list))
    return DBCIResult(cents.astype(np.float32), float(eps), min_pts, float(sigma), n_noise)


# ---------------------------------------------------------------------------
# Fixed-size cluster state
# ---------------------------------------------------------------------------

class ClusterState(NamedTuple):
    """Fixed-size (K_MAX) cluster state, tensors on the weight's device.

    centroids : (K_MAX,) f32 — sorted ascending over the *active* prefix;
                inactive slots hold +inf so nearest-centroid never picks them.
    active    : (K_MAX,) bool
    counts    : (K_MAX,) f32 — H-weighted member mass (used by merge, Eq. 8).
    """
    centroids: torch.Tensor
    active: torch.Tensor
    counts: torch.Tensor

    @property
    def k(self) -> torch.Tensor:
        return self.active.sum()


_INACTIVE = float("inf")


def make_state(centroids, device="cuda") -> ClusterState:
    c = np.sort(np.asarray(centroids, np.float32).reshape(-1))
    k = c.shape[0]
    if k > K_MAX:
        # keep K_MAX evenly spaced representatives
        idx = np.linspace(0, k - 1, K_MAX).round().astype(int)
        c, k = c[idx], K_MAX
    cent = np.full((K_MAX,), np.inf, np.float32)
    cent[:k] = c
    act = np.zeros((K_MAX,), bool)
    act[:k] = True
    dev = resolve_device(device)
    return ClusterState(torch.from_numpy(cent).to(dev), torch.from_numpy(act).to(dev),
                        torch.zeros((K_MAX,), dtype=torch.float32, device=dev))


# --- assignment -------------------------------------------------------------

def assign(w: torch.Tensor, state: ClusterState) -> torch.Tensor:
    """Nearest-active-centroid assignment (int32 codes, w's shape). H-weighting
    does not change the argmin, so assignment is plain nearest — the
    weighting enters refresh/objective.

    The candidates are the finite centroids (inactive slots hold +inf and can
    never be a finite weight's strict first minimum); |w - c| is compared for
    each and the first minimum wins, as the reference's argmin does."""
    slots = torch.nonzero(torch.isfinite(state.centroids)).reshape(-1)
    cents = state.centroids[slots]
    flat = w.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.int32, device=w.device)
    step = max(1, _CHUNK_BYTES // (4 * max(int(slots.numel()), 1)))
    for a in range(0, flat.numel(), step):
        d = (flat[a:a + step, None] - cents).abs_()
        out[a:a + step] = slots[torch.argmin(d, dim=-1)].to(torch.int32)
    return out.reshape(w.shape)


def dequant(codes: torch.Tensor, state: ClusterState) -> torch.Tensor:
    safe = torch.where(state.active, state.centroids, torch.zeros_like(state.centroids))
    return safe[codes.long()]


# --- objective (paper Eq. 4, normalized) -------------------------------------

def objective(w: torch.Tensor, codes: torch.Tensor, state: ClusterState,
              h: torch.Tensor) -> torch.Tensor:
    """Normalized H-weighted distortion  J = sum h (w-c)^2 / sum h w^2
    (a 0-d f32 tensor on w's device).

    The paper's Eq. 4 is sum |w - C| / (2 H^-1) = 0.5 * sum H|w - C|; the
    squared form (the second-order expansion Eq. 2 is quadratic) normalized so
    a single threshold theta works across layers of different scale.
    """
    c = dequant(codes, state)
    num = torch.sum(h * (w - c) ** 2)
    den = torch.sum(h * w ** 2) + 1e-30
    return num / den


# --- H-weighted centroid refresh (Eq. 7 realized as weighted re-estimation) ---

def _sums_sequential(codes: torch.Tensor, vals: torch.Tensor):
    """(mass, weighted sum) per K_MAX slot by a sequential scatter-add, the
    order of the reference's `.at[].add` on the CPU. vals is (2, n) =
    [h, h*w]."""
    out = torch.zeros((2, K_MAX), dtype=torch.float32, device=vals.device)
    out[0].index_add_(0, codes.long(), vals[0])
    out[1].index_add_(0, codes.long(), vals[1])
    return out[0], out[1]


def _sums_masked(codes: torch.Tensor, vals: torch.Tensor, slots: torch.Tensor):
    """The same sums for the slots in `slots` (0 elsewhere), each a masked
    torch.sum, chunk by chunk with the chunks' partial sums added in order:
    one fixed order on a device where a scatter-add would use atomics, so
    two runs give the same bits."""
    out = torch.zeros((2, K_MAX), dtype=torch.float32, device=vals.device)
    step = max(1, _CHUNK_BYTES // (4 * max(int(slots.numel()), 1)))
    zero = torch.zeros((), dtype=torch.float32, device=vals.device)
    for a in range(0, codes.numel(), step):
        hit = codes[a:a + step, None] == slots                       # (chunk, k)
        for r in range(2):
            out[r, slots] += torch.where(hit, vals[r, a:a + step, None], zero).sum(0)
    return out[0], out[1]


def refresh(w: torch.Tensor, codes: torch.Tensor, state: ClusterState,
            h: torch.Tensor) -> ClusterState:
    """Recompute each active centroid as the H-weighted mean of its members.

    Eq. 7 accumulates per-cluster increments (own members + reclassified-in
    members); with reclassification already folded into `codes`, summing
    increments and re-normalizing is exactly the weighted mean below. The
    weighted mean minimizes the quadratic Eq. 4 objective for fixed assignment.
    On the card only the active slots are summed (`assign` never puts a
    weight in another; an inactive slot's mass is 0 there)."""
    flat_w = w.reshape(-1)
    flat_h = h.reshape(-1)
    flat_c = codes.reshape(-1)
    vals = torch.stack([flat_h, flat_h * flat_w])
    if w.device.type == "cpu":
        mass, wsum = _sums_sequential(flat_c, vals)
    else:
        slots = torch.nonzero(state.active).reshape(-1).to(flat_c.dtype)
        mass, wsum = _sums_masked(flat_c, vals, slots)
    new = torch.where(mass > 0, wsum / torch.clamp(mass, min=1e-30), state.centroids)
    new = torch.where(state.active, new, torch.full_like(new, _INACTIVE))
    return ClusterState(new, state.active, mass)


# --- progressive merge (paper Eq. 8) -----------------------------------------

def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once, as XLA's fused multiply-add gives it on
    the CPU (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def merge_closest(state: ClusterState, rule: str = "salience") -> ClusterState:
    """Merge two adjacent *active* centroids into their count-weighted average.

    The standard mass-weighted mean (n_a C_a + n_b C_b)/(n_a+n_b), which
    preserves the cluster mass centroid (the paper's Eq. 8 appears to have the
    subscripts crossed).

    rule="closest"  : the paper's pair choice — smallest centroid gap.
    rule="salience" : beyond-paper — smallest *distortion increase*
                      n_a n_b/(n_a+n_b) * gap^2 (the exact SSE increase of merging
                      two point masses), which protects heavy clusters separated
                      by small gaps.
    """
    c = state.centroids
    # centroids are kept sorted over the active prefix -> adjacent gaps suffice
    pair_ok = state.active[1:] & state.active[:-1]
    inf = torch.full_like(c[1:], float("inf"))
    gaps = torch.where(pair_ok, c[1:] - c[:-1], inf)
    if rule == "closest":
        score = gaps
    else:  # salience: SSE increase of merging the two mass points
        na_, nb_ = state.counts[:-1], state.counts[1:]
        mass = torch.where(na_ + nb_ > 0, na_ * nb_ / torch.clamp(na_ + nb_, min=1e-30),
                           torch.ones_like(na_))
        score = torch.where(pair_ok, mass * gaps ** 2, inf)
    i = torch.argmin(score).reshape(1)           # merge slots i, i+1
    j = i + 1
    na, nb = state.counts[i], state.counts[j]
    ci, cj = c[i], c[j]
    tot = torch.clamp(na + nb, min=1e-30)
    merged = _fma32(na, ci, nb * cj) / tot
    # guard: if counts are both zero (fresh state), plain midpoint
    merged = torch.where(na + nb > 0, merged, 0.5 * (ci + cj))

    cent = c.clone()
    cent[i] = merged
    cent[j] = _INACTIVE
    act = state.active.clone()
    act[j] = False
    cnt = state.counts.clone()
    cnt[i] = na + nb
    cnt[j] = 0.0
    # compact: keep active prefix sorted by re-sorting with inactives at +inf
    order = torch.argsort(cent, stable=True)
    return ClusterState(cent[order], act[order], cnt[order])


def num_active(state: ClusterState) -> int:
    return int(state.k)


def active_centroids(state: ClusterState) -> np.ndarray:
    c = state.centroids.cpu().numpy()
    a = state.active.cpu().numpy()
    return c[a]


# ---------------------------------------------------------------------------
# Baselines: k-means (naive init / SKIM-like) — used by benchmarks & ablations
# ---------------------------------------------------------------------------

def _quantile_sorted(srt: torch.Tensor, qs: np.ndarray) -> np.ndarray:
    """np.quantile(x, qs) (method "linear") from x sorted on its device: the
    same virtual indices and the same lerp as numpy, on the few order
    statistics they need."""
    n = srt.numel()
    virt = (n - 1) * qs
    prev = np.clip(np.floor(virt).astype(np.intp), 0, n - 1)
    nxt = np.clip(prev + 1, 0, n - 1)
    idx = torch.from_numpy(np.concatenate([prev, nxt])).to(srt.device)
    vals = srt[idx].cpu().numpy()
    a, b = vals[:len(qs)], vals[len(qs):]
    gamma = virt - prev
    diff = b - a
    out = a + diff * gamma
    return np.where(gamma >= 0.5, b - diff * (1 - gamma), out)


def _kmeans_1d_tensor(w: torch.Tensor, k: int, iters: int,
                      weights: Optional[torch.Tensor]) -> np.ndarray:
    """`kmeans_1d` on w's device: the same iterations in float64; the bin
    sums are taken in a fixed order of the device's own (masked sums), not
    numpy's sequential order, so a centroid may differ from the host's in the
    last float64 bit (never seen to move a float32 result)."""
    flat = w.detach().reshape(-1).double()
    hw = torch.ones_like(flat) if weights is None else weights.reshape(-1).double()
    qs = np.linspace(0.5 / k, 1 - 0.5 / k, k)
    cents = _quantile_sorted(torch.sort(flat).values, qs)
    dev = flat.device
    bins = torch.arange(k, device=dev)
    hx = hw * flat
    step = max(1, _CHUNK_BYTES // (8 * k))
    for _ in range(iters):
        bounds = torch.from_numpy((cents[1:] + cents[:-1]) / 2).to(dev)
        num = torch.zeros(k, dtype=torch.float64, device=dev)
        den = torch.zeros(k, dtype=torch.float64, device=dev)
        for a in range(0, flat.numel(), step):
            hit = torch.searchsorted(bounds, flat[a:a + step])[:, None] == bins
            num += torch.where(hit, hx[a:a + step, None], 0.0).sum(0)
            den += torch.where(hit, hw[a:a + step, None], 0.0).sum(0)
        num, den = num.cpu().numpy(), den.cpu().numpy()
        new = np.where(den > 0, num / np.maximum(den, 1e-30), cents)
        if np.allclose(new, cents, rtol=0, atol=1e-12):
            cents = new
            break
        cents = np.sort(new)
    return cents.astype(np.float32)


def kmeans_1d(
    w,
    k: int,
    *,
    iters: int = 25,
    weights=None,
    seed: int = 0,
) -> np.ndarray:
    """Weighted Lloyd's in 1-D with quantile init. Returns sorted centroids (k,).
    A numpy `w` runs the reference's numpy code; a tensor runs on its device
    (see `_kmeans_1d_tensor`)."""
    if isinstance(w, torch.Tensor):
        return _kmeans_1d_tensor(w, k, iters, weights)
    flat = np.asarray(w, np.float64).reshape(-1)
    hw = np.ones_like(flat) if weights is None else np.asarray(weights, np.float64).reshape(-1)
    qs = np.linspace(0.5 / k, 1 - 0.5 / k, k)
    cents = np.quantile(flat, qs)
    for _ in range(iters):
        # nearest assignment via boundaries between sorted centroids
        bounds = (cents[1:] + cents[:-1]) / 2
        idx = np.searchsorted(bounds, flat)
        num = np.bincount(idx, weights=hw * flat, minlength=k)
        den = np.bincount(idx, weights=hw, minlength=k)
        new = np.where(den > 0, num / np.maximum(den, 1e-30), cents)
        if np.allclose(new, cents, rtol=0, atol=1e-12):
            cents = new
            break
        cents = np.sort(new)
    return cents.astype(np.float32)


def uniform_grid_centroids(w: np.ndarray, bits: int) -> np.ndarray:
    """'Naive init' baseline from Fig. 7b: a uniform 2^bits grid over the range."""
    if isinstance(w, torch.Tensor):
        lo, hi = float(w.min()), float(w.max())
    else:
        flat = np.asarray(w, np.float64).reshape(-1)
        lo, hi = float(flat.min()), float(flat.max())
    k = 2 ** bits
    return np.linspace(lo, hi, k).astype(np.float32)
