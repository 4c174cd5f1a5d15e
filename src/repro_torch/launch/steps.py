"""Step functions: train and prefill — the port of the JAX package's
`launch/steps.py`.

The reference's builders return a `StepBundle` (the function, its shardings
and abstract inputs for `jax.jit(...).lower(...)`). The port runs on one
device with no mesh, so its builders return the step function alone;
shardings and abstract inputs come with distribution (ROADMAP A7). The
reference's `build_serve_step` has its counterpart in
`launch/engine.py build_decode_fns`. `build_distill_step` is the port of
the codebook fine-tune's step, `ft_step` of `examples/distill_llm.py`.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.registry import Model, lm_loss
from repro_torch.optim.compress import apply_ef
from repro_torch.optim.optimizer import OptConfig, adam_update
from repro_torch.tree import leaves, unflatten


def _value_and_grads(loss_of, params):
    """(value, aux, gradients of the tree's leaves in leaf order): `loss_of(p)
    -> (loss, aux)` differentiated by `torch.autograd.grad` over the floating
    leaves of `params`. Integer leaves, and float leaves the loss does not
    reach, get zero f32 gradients, as `jax.value_and_grad(allow_int=True)`
    gives them."""
    flat = leaves(params)
    var = [x.detach().requires_grad_(True) if x.is_floating_point() else x for x in flat]
    loss, aux = loss_of(unflatten(params, var))
    diff = [v for v in var if v.requires_grad]
    got = iter(torch.autograd.grad(loss, diff, allow_unused=True))
    grads = []
    for v in var:
        g = next(got) if v.requires_grad else None
        grads.append(torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                     if g is None else g)
    return loss.detach(), aux, grads


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
        def loss_of(p):
            logits, aux = model.apply(p, batch)
            loss = lm_loss(logits, batch["targets"], batch["loss_mask"], cfg.vocab)
            return loss + aux_weight * aux, (loss.detach(), aux.detach())

        _, (loss, aux), grads = _value_and_grads(loss_of, params)
        return loss, aux, grads

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


def build_distill_step(model: Model, teacher, opt_cfg: OptConfig) -> Callable:
    """`distill_step(student, opt_state, batch) -> (student, opt_state, kl)`:
    one step of the codebook fine-tune, the counterpart of `ft_step` in
    `examples/distill_llm.py` (the example passes `OptConfig(lr=5e-4,
    warmup_steps=0, total_steps=steps, weight_decay=0.0)`).

    The teacher's logits under `torch.no_grad()`, the student's through the
    LUT path's differentiable route (`kernels/ops.py`), both `log_softmax`ed
    over `[..., :vocab]` in f32; kl = the mean over positions of Σ p_t (log
    p_t - log p_s). Gradients over every float leaf of the student (those it
    does not reach, `inv_scale`, get zeros), then `adam_update`; integer
    leaves (codes, packed) stay frozen. `inv_scale` is not refreshed after
    `smooth` moves, as in the reference."""
    vocab = model.cfg.vocab

    def log_probs(logits):
        return F.log_softmax(logits[..., :vocab].to(torch.float32), dim=-1)

    def distill_step(student, opt_state, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            t = log_probs(model.apply(teacher, batch)[0])

        def loss_of(p):
            s = log_probs(model.apply(p, batch)[0])
            kl = torch.mean(torch.sum(torch.exp(t) * (t - s), dim=-1))
            return kl, None

        kl, _, grads = _value_and_grads(loss_of, student)
        student, opt_state, _ = adam_update(opt_cfg, student, unflatten(student, grads),
                                            opt_state)
        return student, opt_state, kl

    return distill_step


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
