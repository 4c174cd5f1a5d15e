"""LCD distillation loop (paper §3.2-§3.3) — the port of the JAX package's
`repro.core.distill`.

Per-layer self-distillation: the full-precision weights are the teacher; the
clustered weights are the student. With the layer-wise quadratic objective
(Eq. 2-4) and diagonal H, one distillation step is:

  1. Hessian-preconditioned weight update (Eq. 5): grad = H (W' - W_t), so
     W <- W' - eta * grad / diag(H) = W' - eta (W' - W_t) pulls the
     dequantized weights toward the teacher at a uniform rate.
  2. Reclassification (Eq. 6): nearest-centroid re-assignment of the updated
     weights.
  3. Centroid refresh (Eq. 7): H-weighted re-estimation from the new members.
  4. Progressive merge (Eq. 8 / §3.3): when the normalized H-weighted
     distortion J drops below theta, merge the two closest centroids.
  5. Speculative search (§3.3): on stagnation, re-run DBCI with doubled eps,
     optimize p steps, keep if within the accuracy threshold Theta, else back
     off eps <- 1.5 eps and retry; bounded by T rounds.

Steps 1-4 are `lcd_step`, tensors on the teacher's device; step 5 is the
Python loop `distill_layer`. The teacher weight stays on its device (the
card, for compression at scale); only DBCI's subsample and the per-step
scalars the reference reads (J, the centroid count, the merge flag) reach
the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import clustering as C
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class LCDConfig:
    """Hyper-parameters of the LCD distillation loop (paper notation in comments)."""
    eta: float = 1.0                  # Eq. 5 learning rate. eta=1 is the exact
                                      # Newton step (diag-H cancels the curvature)
    theta: float = 0.04               # progressive-merge distortion threshold (theta)
    merge_rule: str = "salience"      # "closest" (paper Eq. 8 pair choice) | "salience"
    target_centroids: int = 0         # stop merging below this (0 = fully adaptive)
    max_steps: int = 400              # total distillation step budget (T-ish)
    spec_patience: int = 25           # steps without merge before speculative search
    spec_iters: int = 30              # p — iterations granted to a speculative restart
    spec_tolerance: float = 1.08      # Theta — accept if J_new <= tol * J_old
    spec_rounds: int = 3              # T — speculative rounds before giving up
    max_init_centroids: int = 20      # DBCI cap (paper: 15-20 empirically)
    damp_frac: float = 1e-2
    seed: int = 0


@dataclasses.dataclass
class DistillReport:
    """Trajectory of one layer's distillation — feeds Fig. 7 / Fig. 8 benchmarks."""
    centroid_history: List[int]
    objective_history: List[float]
    trace_history: List[float]
    speculative_events: List[Tuple[int, str]]   # (step, accepted/reverted)
    final_centroids: np.ndarray
    final_objective: float


# ---------------------------------------------------------------------------
# One LCD step (Eq. 5-8)
# ---------------------------------------------------------------------------

def _update(w_student: torch.Tensor, w_teacher: torch.Tensor, eta: float) -> torch.Tensor:
    """Eq. 5: W' - eta (W' - W_t) in float32. At eta != 1 the multiply and
    the subtract are one fused operation in the reference (XLA contracts them
    on the CPU), so the port rounds once too, through float64."""
    d = w_student - w_teacher
    if eta == 1.0:
        return w_student - d
    e = float(np.float32(eta))
    return (w_student.double() - e * d.double()).to(torch.float32)


def lcd_step(
    w_teacher: torch.Tensor,  # FP teacher weights (the model's own weights — self-distill)
    codes: torch.Tensor,      # int32, same shape
    state: C.ClusterState,
    h: torch.Tensor,          # diag Hessian, same shape as w (broadcasted)
    eta: float,
    theta: float,
    min_k: int,
    allow_merge: bool = True,
    merge_rule: str = "salience",
):
    """Returns (codes', state', J' (0-d tensor), merged? (bool)). Whether to
    merge is decided on the host from J and the centroid count, the two
    values the reference's `lax.cond` branches on."""
    w_student = C.dequant(codes, state)

    # (1) Eq. 5 — preconditioned update toward the teacher.
    w_upd = _update(w_student, w_teacher, eta)

    # (2) Eq. 6 — reclassification == nearest re-assignment of updated weights.
    codes2 = C.assign(w_upd, state)

    # (3) Eq. 7 — H-weighted centroid refresh from updated member positions,
    # then a defensive re-sort (cheap, K_MAX=32) with the codes re-indexed.
    state2 = C.refresh(w_upd, codes2, state, h)
    order = torch.argsort(state2.centroids, stable=True)
    state2 = C.ClusterState(state2.centroids[order], state2.active[order], state2.counts[order])
    inverse = torch.argsort(order, stable=True).to(torch.int32)
    codes2 = inverse.index_select(0, codes2.reshape(-1)).reshape(codes2.shape)

    # Distortion against the *teacher* (the quantity Eq. 4 bounds).
    j = C.objective(w_teacher, codes2, state2, h)

    # (4) progressive merge when distortion is below theta and we may shrink;
    # J compares in float32, as the reference's traced comparison does.
    do_merge = (allow_merge and bool(np.float32(float(j)) < np.float32(theta))
                and C.num_active(state2) > min_k)
    if not do_merge:
        return codes2, state2, j, False
    s3 = C.merge_closest(state2, merge_rule)
    c3 = C.assign(w_upd, s3)
    s3 = C.refresh(w_upd, c3, s3, h)
    return c3, s3, C.objective(w_teacher, c3, s3, h), True


# ---------------------------------------------------------------------------
# The Python loop: progressive + speculative optimization (§3.3)
# ---------------------------------------------------------------------------

def _init_from_dbci(w: torch.Tensor, cfg: LCDConfig,
                    eps_scale: float) -> Tuple[C.ClusterState, torch.Tensor]:
    res = C.dbci_init(
        w,
        max_centroids=cfg.max_init_centroids,
        eps_scale=eps_scale,
        seed=cfg.seed,
    )
    state = C.make_state(res.centroids, device=w.device)
    codes = C.assign(w.to(torch.float32), state)
    return state, codes


def _on_device(w_teacher, h_diag, device):
    """(teacher, h) as float32 tensors of the teacher's shape on one device:
    the teacher's own when it is a tensor, else `device`."""
    if isinstance(w_teacher, torch.Tensor):
        dev = w_teacher.device
        wt = w_teacher.detach().to(torch.float32)
    else:
        dev = resolve_device(device)
        wt = torch.from_numpy(np.asarray(w_teacher, np.float32)).to(dev)
    hd = h_diag if isinstance(h_diag, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(h_diag, np.float32)))
    h = torch.broadcast_to(hd.to(dev, torch.float32), wt.shape).contiguous()
    return wt, h


def distill_layer(
    w_teacher,
    h_diag,
    cfg: LCDConfig = LCDConfig(),
    *,
    init: str = "dbci",          # dbci | naive4bit | kmeans:<k>  (Fig. 7b ablation)
    progressive: bool = True,    # PO on/off (Fig. 7b ablation)
    speculative: bool = True,    # SO on/off (Fig. 7b ablation)
    device="cuda",
) -> Tuple[torch.Tensor, C.ClusterState, DistillReport]:
    """Run the full LCD loop on one weight tensor.

    `w_teacher` and `h_diag` are tensors (the loop runs on the teacher's
    device) or numpy arrays (moved to `device`, the card unless the caller
    asks for the CPU). Returns (codes int32 tensor on that device, final
    ClusterState, DistillReport)."""
    wt, h = _on_device(w_teacher, h_diag, device)
    return _distill(w_teacher, wt, h, cfg, init, progressive, speculative)


def _distill(w_teacher, wt, h, cfg, init, progressive, speculative):
    """`distill_layer` on the device tensors (wt, h); `w_teacher` as the
    caller gave it, which a k-means or grid init reads (a numpy teacher stays
    on the host there, as in the reference)."""
    src = w_teacher if isinstance(w_teacher, np.ndarray) else wt
    if init == "dbci":
        state, codes = _init_from_dbci(wt, cfg, eps_scale=1.0)
    elif init == "naive4bit":
        state = C.make_state(C.uniform_grid_centroids(src, 4), device=wt.device)
        codes = C.assign(wt, state)
    elif init.startswith("kmeans:"):
        k = int(init.split(":")[1])
        state = C.make_state(C.kmeans_1d(src, k, seed=cfg.seed), device=wt.device)
        codes = C.assign(wt, state)
    else:
        raise ValueError(f"unknown init scheme {init!r}")

    min_k = max(cfg.target_centroids, 2)
    hist_k: List[int] = [C.num_active(state)]
    hist_j: List[float] = []
    hist_tr: List[float] = []
    spec_events: List[Tuple[int, str]] = []
    h_sum = np.float32(float(torch.sum(h)))     # the trace monitor's H trace

    steps_since_merge = 0
    spec_round = 0
    eps_scale = 2.0
    j_prev = np.inf

    step = 0
    while step < cfg.max_steps:
        codes, state, j, merged = lcd_step(
            wt, codes, state, h, cfg.eta, cfg.theta, min_k,
            allow_merge=progressive, merge_rule=cfg.merge_rule,
        )
        jf = float(j)
        kf = C.num_active(state)
        hist_j.append(jf)
        hist_k.append(kf)
        hist_tr.append(float(h_sum * np.float32(jf)))  # H-trace-scaled distortion monitor
        step += 1

        if bool(merged):
            steps_since_merge = 0
        else:
            steps_since_merge += 1

        # --- speculative search trigger: stagnation + non-monotone trace ----
        stagnated = steps_since_merge >= cfg.spec_patience
        non_monotone = jf > j_prev - 1e-12
        j_prev = jf
        if speculative and stagnated and non_monotone and spec_round < cfg.spec_rounds:
            spec_round += 1
            snap = (codes, state, jf, kf)
            try:
                state_s, codes_s = _init_from_dbci(wt, cfg, eps_scale=eps_scale)
            except ValueError:
                break
            # p iterations of progressive-only optimization on the candidate
            js = np.inf
            for _ in range(cfg.spec_iters):
                codes_s, state_s, js, _m = lcd_step(
                    wt, codes_s, state_s, h, cfg.eta, cfg.theta, min_k,
                    allow_merge=True, merge_rule=cfg.merge_rule,
                )
                step += 1
            js = float(js)
            ks = C.num_active(state_s)
            accept = (ks < kf and js <= cfg.spec_tolerance * max(jf, 1e-12)) or (
                ks <= kf and js < jf
            )
            if accept:
                codes, state = codes_s, state_s
                spec_events.append((step, f"accepted k={ks} J={js:.3e} (eps x{eps_scale})"))
                eps_scale = 2.0
                steps_since_merge = 0
            else:
                codes, state = snap[0], snap[1]
                spec_events.append((step, f"reverted (cand k={ks} J={js:.3e}, eps x{eps_scale})"))
                eps_scale = 1.5  # paper: back off 2*eps -> 1.5*eps
        elif stagnated and not speculative:
            break  # PO-only converges (possibly prematurely — Fig. 7b)

        if cfg.target_centroids and kf <= cfg.target_centroids and jf < cfg.theta:
            break

    final_j = float(C.objective(wt, codes, state, h))
    report = DistillReport(
        centroid_history=hist_k,
        objective_history=hist_j,
        trace_history=hist_tr,
        speculative_events=spec_events,
        final_centroids=C.active_centroids(state),
        final_objective=final_j,
    )
    return codes, state, report


def distill_layer_to_k(
    w_teacher,
    h_diag,
    k: int,
    cfg: Optional[LCDConfig] = None,
    *,
    init: str = "dbci",
    progressive: bool = True,
    speculative: bool = True,
    device="cuda",
) -> Tuple[torch.Tensor, C.ClusterState, DistillReport]:
    """Convenience: distill until exactly k centroids remain (Table 1/2 settings
    fix the centroid budget, e.g. 8 centroids == 3 equivalent bits), then
    polish 30 steps at fixed k with merging disabled. Arguments as
    `distill_layer`."""
    cfg = dataclasses.replace(cfg or LCDConfig(), target_centroids=k,
                              theta=np.inf)  # always merge until k reached
    wt, h = _on_device(w_teacher, h_diag, device)
    cj, st, rep = _distill(w_teacher, wt, h, cfg, init, progressive, speculative)
    for _ in range(30):
        cj, st, j, _ = lcd_step(wt, cj, st, h, cfg.eta, 0.0, k,
                                allow_merge=False, merge_rule=cfg.merge_rule)
    rep.final_objective = float(j)
    rep.final_centroids = C.active_centroids(st)
    return cj, st, rep
