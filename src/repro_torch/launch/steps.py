"""Step functions: train, prefill and serve — the port of the JAX package's
`launch/steps.py`.

`build_serve_step` and `build_prefill_step` return a `StepBundle`, as the
reference's do: the step function, its placements (`distributed/sharding.py`
specs from the model's logical names under the installed `use_rules`
context) and its abstract inputs, tensors on the "meta" device. The bundle
calls its function. `build_train_step` returns the step function alone: the
trainer runs on one device (training on a mesh waits, ROADMAP A7).
`build_distill_step` is the port of the codebook fine-tune's step, `ft_step`
of `examples/distill_llm.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (auto_shard, named_sharding, parse_names,
                                              tree_shardings)
from repro_torch.models.config import ShapeConfig, input_specs
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
    apply_ef`) before the update. Returns only the step function: training
    on a mesh waits (ROADMAP A7)."""
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


BATCH_NAMES = {
    "tokens": "batch,.",
    "targets": "batch,.",
    "loss_mask": "batch,.",
    "pos": "",
    "img_embeds": "batch,.,.",
    "frames": "batch,.,.",
}


def batch_shardings(batch_specs: Dict[str, torch.Tensor], sr=None):
    return {k: named_sharding(tuple(v.shape), parse_names(BATCH_NAMES[k]), sr)
            for k, v in batch_specs.items()}


@dataclasses.dataclass
class StepBundle:
    """A step function with its placements and abstract inputs (tensors on
    the "meta" device); calling the bundle calls the function."""
    fn: Callable
    in_shardings: Tuple
    out_shardings: Any
    abstract_inputs: Tuple

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def build_prefill_step(model: Model, shape: ShapeConfig) -> StepBundle:
    """`prefill_step(params, batch) -> (B, padded_vocab)`: the full-sequence
    forward under `torch.no_grad()`, returning only the last position's
    logits (the next-token distribution). Placements of the params, the
    batch and the logits under the installed rules; abstract params and
    batch."""
    cfg = model.cfg

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _ = model.apply(params, batch)
        return logits[:, -1, :]

    aparams = model.abstract()
    ps = tree_shardings(aparams, model.names())
    abatch = input_specs(cfg, shape)
    out_sh = named_sharding((shape.global_batch, cfg.padded_vocab), ("batch", "vocab"))
    return StepBundle(prefill_step, (ps, batch_shardings(abatch)), out_sh, (aparams, abatch))


def build_serve_step(model: Model, shape: ShapeConfig, *, clustered_params=None,
                     clustered_names=None) -> StepBundle:
    """The static path's decode step, `serve_step(params, cache, batch) ->
    (next_tok (B,) int32, cache)` (the cache updated in place). With
    `clustered_params` / `clustered_names` (LCD serving) the parameter tree
    is the ClusteredTensor one, the packed codes streamed in place of dense
    weights. Placements under the installed rules; abstract params, cache
    (`model.init_cache` on "meta") and batch."""
    cfg = model.cfg

    @torch.no_grad()
    def serve_step(params, cache, batch):
        logits, cache = model.decode(params, cache, batch)
        return torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32), cache

    aparams = clustered_params if clustered_params is not None else model.abstract()
    names = clustered_names if clustered_names is not None else model.names()
    ps = (tree_shardings(aparams, names) if clustered_params is None
          else auto_shard(aparams, names))
    acache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    cache_names = model.cache_names
    cache_sh = {k: named_sharding(tuple(v.shape), parse_names(cache_names[k])
                                  if k in cache_names else (None,) * v.ndim)
                for k, v in acache.items()}
    abatch = input_specs(cfg, shape)
    tok_sh = named_sharding((shape.global_batch,), ("batch",))
    return StepBundle(serve_step, (ps, cache_sh, batch_shardings(abatch)), (tok_sh, cache_sh),
                      (aparams, acache, abatch))

