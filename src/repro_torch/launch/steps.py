"""Step functions: train and prefill — the port of the JAX package's
`launch/steps.py`.

The reference's builders return a `StepBundle` (the function, its shardings
and abstract inputs for `jax.jit(...).lower(...)`). The port runs on one
device with no mesh, so its builders return the step function alone;
shardings and abstract inputs come with distribution (ROADMAP A7). The
reference's `build_serve_step` has its counterpart in
`launch/engine.py build_decode_fns`.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.registry import Model, lm_loss
from repro_torch.optim.compress import apply_ef
from repro_torch.optim.optimizer import OptConfig, adam_update
from repro_torch.tree import leaves, unflatten


def build_train_step(
    model: Model,
    opt_cfg: OptConfig = OptConfig(),
    *,
    grad_compress: bool = False,
    microbatch: int = 0,           # 0 = no accumulation; else per-step splits
    aux_weight: float = 0.01,
) -> Callable:
    """`train_step(params, opt_state, ef_state, batch) -> (params, opt_state,
    ef_state, metrics)`, metrics {"loss", "aux", "grad_norm"} as 0-d tensors.

    Gradients come from `torch.autograd.grad` over the floating leaves of
    `params` (integer leaves get zero gradients, and AdamW keeps them frozen).
    With `microbatch` > 1 the batch is split along its first axis and the
    f32 gradients of the splits are summed and divided by their count, as
    the reference's scan does. With `grad_compress` the gradients pass
    through the int8 error-feedback round trip (`optim/compress.py
    apply_ef`) before the update. Returns only the step function: the
    reference's shardings and abstract inputs belong to a mesh (ROADMAP A7)."""
    cfg = model.cfg

    def grads_of(params, batch):
        flat = leaves(params)
        var = [x.detach().requires_grad_(True) if x.is_floating_point() else x
               for x in flat]
        logits, aux = model.apply(unflatten(params, var), batch)
        loss = lm_loss(logits, batch["targets"], batch["loss_mask"], cfg.vocab)
        diff = [v for v in var if v.requires_grad]
        got = iter(torch.autograd.grad(loss + aux_weight * aux, diff, allow_unused=True))
        grads = []
        for v in var:
            g = next(got) if v.requires_grad else None
            grads.append(torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                         if g is None else g)
        return loss.detach(), aux.detach(), grads

    def train_step(params, opt_state, ef_state, batch: Dict[str, torch.Tensor]):
        if microbatch and microbatch > 1:
            acc, loss_sum = None, 0.0
            for i in range(microbatch):
                mb = {k: v.reshape(microbatch, v.shape[0] // microbatch, *v.shape[1:])[i]
                      for k, v in batch.items()}
                ls, _, g = grads_of(params, mb)
                g = [x.to(torch.float32) for x in g]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                loss_sum = loss_sum + ls
            grads = [a / microbatch for a in acc]
            loss = loss_sum / microbatch
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        else:
            loss, aux, grads = grads_of(params, batch)
        grads = unflatten(params, grads)
        if grad_compress:
            grads, ef_state = apply_ef(grads, ef_state)
        params, opt_state, gnorm = adam_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, ef_state, {"loss": loss, "aux": aux, "grad_norm": gnorm}

    return train_step


def build_prefill_step(model: Model) -> Callable:
    """`prefill_step(params, batch) -> (B, padded_vocab)`: the full-sequence
    forward under `torch.no_grad()`, returning only the last position's
    logits (the next-token distribution). Returns only the step function
    (see `build_train_step`)."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _ = model.apply(params, batch)
        return logits[:, -1, :]

    return prefill_step
