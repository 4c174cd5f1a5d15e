"""Step functions: train, prefill and serve — the port of the JAX package's
`launch/steps.py`.

`build_train_step`, `build_serve_step` and `build_prefill_step` return a
`StepBundle`, as the reference's do: the step function, its placements
(`distributed/sharding.py` specs from the model's logical names under the
installed `use_rules` context) and its abstract inputs, tensors on the
"meta" device. The bundle calls its function.

The train step runs on plain tensors (one device) or on a training state
placed on a (data, model) mesh by the bundle's own placements
(`place_train_state`): the reference's FSDP cut of every weight's d_model
dim over the data axes, Adam's moments and the EF residuals cut alike.
One body serves both: each data rank gathers the params whole, runs the
forward and backward of its batch rows on the compute layout of the model
axis (each model rank's projections on its column shard, its own heads'
attention, a recurrent mixer's heads: `distributed/layout.py
serving_names`), the gradients are summed over the data ranks in rank
order and cut back to each rank's part, and Adam runs on every part; an
MoE model runs every data rank's rows as one, so that a step's tokens are
routed once; plain tensors are the case of one data rank
holding everything, with nothing to gather or cut (`_mesh_layout`). Every
family trains on a mesh.
`build_distill_step` is the port of the codebook fine-tune's step,
`ft_step` of `examples/distill_llm.py`, on one device.
"""
from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.api import CT_ARRAY_FIELDS, is_clustered
from repro_torch.distributed.layout import SERVE_RULES, serving_names
from repro_torch.distributed.placement import MeshTree, cut_like, cut_model, place
from repro_torch.distributed.sharding import (logical_to_spec, named_sharding,
                                              parse_names, tree_shardings, use_rules)
from repro_torch.models.config import ShapeConfig, input_specs
from repro_torch.models.registry import Model, lm_nll
from repro_torch.optim.compress import EFState, abstract_ef, round_trip
from repro_torch.optim.optimizer import (AdamState, OptConfig, abstract_adam, adam_update,
                                         update_tensors)
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
    shape: ShapeConfig,
    opt_cfg: OptConfig = OptConfig(),
    *,
    grad_compress: bool = False,
    microbatch: int = 0,           # 0 = no accumulation; else per-step splits
    aux_weight: float = 0.01,
) -> StepBundle:
    """The train step as a `StepBundle`: `fn(params, opt_state, ef_state,
    batch) -> (params, opt_state, ef_state, metrics)`, metrics {"loss",
    "aux", "grad_norm"} as 0-d tensors; `in_shardings` (params, Adam state,
    EF state, batch) and `out_shardings` (params, Adam state, EF state,
    metrics) under the installed rules, as the reference's: params by their
    logical names (the FSDP `embed` rule included), Adam's moments and the
    EF residuals as the params, the batch on `batch`; `abstract_inputs`
    (params, `abstract_adam`, `abstract_ef` or EFState(None), the batch of
    `shape`) on "meta". Build it under `use_rules(mesh)`.

    The step runs on the device of its tensors: gradients from
    `torch.autograd.grad` over the floating leaves of `params` (integer
    leaves get zero gradients, and AdamW keeps them frozen). With
    `microbatch` > 1 the batch is split along its first axis (the
    reference's chunks of the global batch) and the f32 gradients of the
    splits are summed and divided by their count, as the reference's scan
    does. With `grad_compress` the gradients pass through the int8
    error-feedback round trip (`optim/compress.py round_trip`, each leaf
    under its whole absmax) before the update.

    On a state placed by `place_train_state` (`MeshTree`s) each data rank
    of a split (`train_rows`, in rank order) gathers the params whole
    (`MeshTree.whole`, the FSDP all-gather), cuts them over the model axis
    by the compute layout (`serving_names` under SERVE_RULES: each
    projection by its output columns, the vocab tables whole; a weight
    stored cut along K is so gathered and re-cut) and differentiates its
    masked NLL sum over the split's GLOBAL mask count (so uneven masks give
    the one-device loss), plus `aux_weight` times its aux; the f32
    gradients are summed over the ranks in rank order. An MoE model's split
    is one range of every data rank's rows (its routing groups the whole
    token set, as the reference's one program does), so its aux is the
    whole set's, reported (zero with `microbatch` > 1, as the reference's).
    The gradients are cut back to each rank's part
    (`cut_like`, the reduce-scatter's cut), and EF and Adam run on the
    parts (`update_tensors`: clipped by the global norm of every part).
    Plain tensors are the case of one rank: the same body, the same
    function of the same inputs."""
    cfg = model.cfg
    n_mb = microbatch if microbatch and microbatch > 1 else 1

    def train_step(params, opt_state, ef_state, batch: Dict[str, torch.Tensor]):
        whole, rows, compute = _mesh_layout(model, params)
        size = batch["tokens"].shape[0] // n_mb
        acc, loss, aux = None, None, None
        for i in range(n_mb):
            ranks = [{k: v[i * size + r0:i * size + r1] for k, v in batch.items()}
                     for r0, r1 in rows(size)]
            count = reduce(torch.add, [torch.sum(b["loss_mask"].to(torch.float32))
                                       for b in ranks])
            denom = torch.clamp(count, min=1.0)
            for b in ranks:
                def loss_of(p, b=b):
                    logits, a = model.apply(compute(p), b)
                    part = lm_nll(logits, b["targets"], b["loss_mask"], cfg.vocab)[0] / denom
                    return part + aux_weight * a, (part.detach(), a.detach())

                _, (ls, ax), g = _value_and_grads(loss_of, whole)
                g = [x.to(torch.float32) for x in g]
                acc = g if acc is None else [s + x for s, x in zip(acc, g)]
                loss = ls if loss is None else loss + ls
                aux = ax if aux is None else aux + ax
        if n_mb > 1:
            grads = [a / n_mb for a in acc]
            loss = loss / n_mb
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        else:
            # the leaf's own dtype, as one differentiation gives it
            grads = [a.to(w.dtype) if w.is_floating_point() else a
                     for a, w in zip(acc, leaves(whole))]
        grads = unflatten(whole, grads)
        del whole, acc                     # a placed state's gathered copies, freed before Adam
        if isinstance(params, MeshTree):
            grads = cut_like(grads, params)
        if grad_compress:
            outs = []
            for gs, rs in zip(_leaf_parts(grads), _leaf_parts(ef_state)):
                amax = reduce(torch.maximum, [torch.amax(torch.abs(g.to(torch.float32) + r))
                                              for g, r in zip(gs, rs)])
                outs += [round_trip(g, r, amax) for g, r in zip(gs, rs)]
            grads = _with_parts(grads, [d for d, _ in outs])
            ef_state = _with_parts(ef_state, [r for _, r in outs])
        p, g = _parts(params), _parts(grads)
        o = _parts(opt_state)              # the step, then m and v as the params
        step, new, gnorm = update_tensors(opt_cfg, [p, g, o[1:1 + len(p)], o[1 + len(p):]],
                                          o[0])
        params = _with_parts(params, [n[0] for n in new])
        opt_state = _with_parts(opt_state, [step] + [n[1] for n in new] + [n[2] for n in new])
        return params, opt_state, ef_state, {"loss": loss, "aux": aux, "grad_norm": gnorm}

    aparams = model.abstract()
    ps = tree_shardings(aparams, model.names())
    aopt = abstract_adam(aparams)
    opt_sh = AdamState(named_sharding((), ()), ps, ps)
    aef = abstract_ef(aparams) if grad_compress else EFState(None)
    ef_sh = EFState(ps) if grad_compress else EFState(None)
    abatch = input_specs(cfg, shape)
    metrics_sh = {k: named_sharding((), ()) for k in ("loss", "aux", "grad_norm")}
    return StepBundle(train_step, (ps, opt_sh, ef_sh, batch_shardings(abatch)),
                      (ps, opt_sh, ef_sh, metrics_sh), (aparams, aopt, aef, abatch))


def place_train_state(bundle: "StepBundle", mesh, params, opt_state, ef_state=EFState(None)):
    """(params, Adam state, EF state) placed on `mesh` by a train bundle's
    `in_shardings` (`distributed/placement.py place(fsdp=True)`): each a
    `MeshTree`, EFState(None) kept as it is. Build the bundle under
    `use_rules(mesh)`."""
    ps, opt_sh, ef_sh, _ = bundle.in_shardings
    ef = ef_state if ef_state.residual is None else place(ef_state, ef_sh, mesh, fsdp=True)
    return (place(params, ps, mesh, fsdp=True), place(opt_state, opt_sh, mesh, fsdp=True), ef)


def train_rows(mesh, n_rows: int) -> List[Tuple[int, int]]:
    """The distinct row ranges the data ranks hold of a training batch of
    `n_rows`, in data-rank order: the "batch" rule's cut over the data axes,
    or (0, n_rows) once where it leaves the batch whole: every data rank
    then holds the same rows, which the step computes and counts once (not
    `placement.data_rows`' serving fallback, which runs the rows on every
    data rank)."""
    with use_rules(mesh):
        entry = logical_to_spec((n_rows,), ("batch",))[0]
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    k = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    size = n_rows // k
    return [(g * size, (g + 1) * size) for g in range(k)]


def _mesh_layout(model: Model, params):
    """(the params whole, `rows(n)`: each data rank's rows of a split of
    n, compute(p): the params as the model ranks run them) of the train
    step. Plain tensors: themselves, one rank of every row, as they are. A
    placed state: `MeshTree.whole` (the FSDP all-gather), `train_rows`, and
    `cut_model` by the compute layout (`serving_names` under SERVE_RULES).
    An MoE model's split is one range, its rows in data-rank order: its
    routing groups the split's whole token set (capacities, drops and the
    aux are the whole set's, as in the reference's one program)."""
    if not isinstance(params, MeshTree):
        return params, (lambda n: [(0, n)]), (lambda p: p)
    mesh = params.mesh
    n_model = mesh.shape.get("model", 1)
    with use_rules(mesh, SERVE_RULES, fsdp=False):
        layout = tree_shardings(model.abstract(), serving_names(model))
    rows = ((lambda n: [(0, n)]) if model.cfg.n_experts else
            (lambda n: train_rows(mesh, n)))
    return params.whole(), rows, (lambda p: cut_model(p, layout, n_model))


def _leaf_parts(tree) -> List[List[torch.Tensor]]:
    """Per tensor leaf, its distinct tensors: a placed tree's data parts in
    rank order, each's model parts in rank order (`MeshTree.leaf_groups`);
    a plain tree's leaf alone."""
    if isinstance(tree, MeshTree):
        return [[t for ps in groups for t in ps] for _, _, groups in tree.leaf_groups()]
    return [[t] for t in leaves(tree)]


def _parts(tree) -> List[torch.Tensor]:
    return [t for ts in _leaf_parts(tree) for t in ts]


def _with_parts(tree, new: List[torch.Tensor]):
    """`tree` with its distinct tensors replaced, in `_parts` order."""
    return tree.with_parts(new) if isinstance(tree, MeshTree) else unflatten(tree, new)


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


def _clustered_shardings(tree, names):
    """`tree_shardings` over a tree whose ClusteredTensor leaves carry a
    ClusteredTensor of names: each array field by its own names (a field
    the tensor lacks, or its names, gives None)."""
    if isinstance(tree, dict):
        return {k: _clustered_shardings(tree[k], names[k]) for k in tree}
    if not is_clustered(tree):
        return named_sharding(tuple(tree.shape), parse_names(names))
    return type(tree)(**{
        f: (None if getattr(tree, f) is None or getattr(names, f) is None else
            named_sharding(tuple(getattr(tree, f).shape), parse_names(getattr(names, f))))
        for f in CT_ARRAY_FIELDS}, nbits=tree.nbits)


def build_serve_step(model: Model, shape: ShapeConfig, *, clustered_params=None,
                     clustered_names=None) -> StepBundle:
    """The static path's decode step, `serve_step(params, cache, batch) ->
    (next_tok (B,) int32, cache)` (the cache updated in place). With
    `clustered_params` / `clustered_names` (LCD serving; the names of
    `core/clustered_params.py clustered_names`, a ClusteredTensor of names
    at each clustered leaf) the parameter tree is the ClusteredTensor one,
    the packed codes streamed in place of dense weights, each field placed
    by its own names as the JAX package places them. Placements under the
    installed rules; abstract params, cache (`model.abstract_cache`) and
    batch."""
    cfg = model.cfg

    @torch.no_grad()
    def serve_step(params, cache, batch):
        logits, cache = model.decode(params, cache, batch)
        return torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32), cache

    aparams = clustered_params if clustered_params is not None else model.abstract()
    names = clustered_names if clustered_names is not None else model.names()
    ps = _clustered_shardings(aparams, names)
    acache = model.abstract_cache(shape.global_batch, shape.seq_len)
    cache_names = model.cache_names
    cache_sh = {k: named_sharding(tuple(v.shape), parse_names(cache_names[k])
                                  if k in cache_names else (None,) * v.ndim)
                for k, v in acache.items()}
    abatch = input_specs(cfg, shape)
    tok_sh = named_sharding((shape.global_batch,), ("batch",))
    return StepBundle(serve_step, (ps, cache_sh, batch_shardings(abatch)), (tok_sh, cache_sh),
                      (aparams, acache, abatch))

