"""AdamW + LR schedule + global-norm clipping over a tree of tensors — the
port of the JAX package's `optim/optimizer.py`.

Plain functions over the parameter tree (nested dicts of tensors, possibly
with ClusteredTensor leaves), not a `torch.optim` class: the tree, the state
(`AdamState`, a NamedTuple with the reference's fields) and so the
checkpoint's leaf paths stay the reference's. The moments live in f32; the
update is computed in f32 and cast back to each parameter's dtype.

`update_tensors` is the update over aligned lists of tensors: the train
step on a mesh (`launch/steps.py`) passes it every rank's distinct parts,
so the clip scale comes from the global norm of the whole gradient tree
and every other operation, elementwise, gives each part its slice of the
whole update.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to `lr`, then cosine decay to `min_lr_frac * lr`, as an
    f32 tensor on `step`'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_adam(params) -> AdamState:
    """Zero f32 moments shaped like every leaf, step 0 on the leaves' device."""
    dev = next((x.device for x in leaves(params)), torch.device("cpu"))

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                     tree_map(zeros, params), tree_map(zeros, params))


def abstract_adam(aparams) -> AdamState:
    """The Adam state of an abstract parameter tree (tensors on "meta"): f32
    moments shaped like every leaf and an int32 step, on "meta"."""
    def z(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return AdamState(torch.empty((), dtype=torch.int32, device="meta"),
                     tree_map(z, aparams), tree_map(z, aparams))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every floating leaf, in f32 (integer
    leaves are skipped)."""
    total = None
    for x in leaves(tree):
        if x.is_floating_point():
            sq = torch.sum(torch.square(x.to(torch.float32)))
            total = sq if total is None else total + sq
    return torch.sqrt(total) if total is not None else torch.zeros(())


@torch.no_grad()
def adam_update(cfg: OptConfig, params, grads, state: AdamState):
    """One AdamW step with global-norm clipping. Returns (params', state',
    the gradients' global norm before clipping). Integer leaves (an LCD
    tensor's codes) are frozen; weight decay is decoupled and applies to
    leaves with ndim >= 2 only."""
    step, new, gnorm = update_tensors(
        cfg, [leaves(t) for t in (params, grads, state.m, state.v)], state.step)
    return (unflatten(params, [n[0] for n in new]),
            AdamState(step, unflatten(state.m, [n[1] for n in new]),
                      unflatten(state.v, [n[2] for n in new])), gnorm)


@torch.no_grad()
def update_tensors(cfg: OptConfig, flat, step):
    """`adam_update` over aligned lists `flat` = [params, grads, m, v] of
    tensors and the step count: (step + 1, [(p', m', v')] a tensor, the
    gradients' global norm, their squares summed in list order)."""
    gnorm = global_norm(flat[1])
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = step + 1
    lr = lr_at(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.beta1, dtype=torch.float32, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.beta2, dtype=torch.float32, device=sf.device), sf)

    def upd(p, g, m, v):
        if not p.is_floating_point():
            return p, m, v
        gf = g.to(torch.float32) * scale
        m2 = cfg.beta1 * m + (1 - cfg.beta1) * gf
        v2 = cfg.beta2 * v + (1 - cfg.beta2) * gf * gf
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    if len({len(f) for f in flat}) != 1:
        raise ValueError("adam_update: params, grads and moments differ in structure")
    return step, [upd(*leaf) for leaf in zip(*flat)], gnorm
