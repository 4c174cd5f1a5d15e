"""Elastic scaling / failure recovery controller — the port of the JAX
package's `launch/elastic.py`.

The contract, run here in one process over a mesh of repeated devices
([cuda:0] x n on the card, [cpu] x n in the tests):

  1. the training loop checkpoints through CheckpointManager (atomic commits);
  2. on node failure / straggler exclusion, the launcher computes the
     surviving chip set and calls `make_elastic_mesh(n_chips)`: model
     parallelism stays fixed, the (pod, data) product shrinks;
  3. state is restored *re-sharded*: `CheckpointManager.restore` takes the
     NEW mesh's shardings, so the FSDP parts are re-laid-out through host
     memory (no all-to-all of optimizer state at the collective layer);
  4. the data pipeline is deterministic per step, so no sample is lost or
     duplicated after the re-mesh;
  5. training resumes from the last committed step.

`simulate_failure_and_resume` runs that sequence end to end.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch.mesh import (make_elastic_mesh, make_host_mesh, make_mesh,
                                     visible_devices)
from repro_torch.launch.steps import build_train_step, place_train_state
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import Model
from repro_torch.optim.compress import EFState
from repro_torch.optim.optimizer import OptConfig, init_adam
from repro_torch.tree import leaves
from repro_torch.utils import logger


@dataclasses.dataclass
class ElasticReport:
    steps_before: int
    steps_after: int
    resumed_step: int
    loss_before: float
    loss_after: float
    mesh_before: dict
    mesh_after: dict
    # every restored leaf, gathered whole, torch.equal to the leaf saved
    restored_equal: Optional[bool] = None


def _run_steps(step_fn, params, opt_state, data_fn, start: int, n: int):
    loss = float("nan")
    for s in range(start, start + n):
        params, opt_state, _, metrics = step_fn(params, opt_state, EFState(None), data_fn(s))
        loss = float(metrics["loss"])
    return params, opt_state, loss


def simulate_failure_and_resume(model: Model, ckpt_dir: str, *, data_fn, steps_each: int = 5,
                                batch: int = 8, seq: int = 64,
                                devices: Optional[Sequence] = None,
                                model_parallel: int = 1) -> ElasticReport:
    """Train on the host mesh over `devices` (default: the visible cards;
    (n / model_parallel, model_parallel), the reference's `make_host_mesh()`
    at model_parallel 1), checkpoint, lose half of the chips, rebuild the
    mesh with `make_elastic_mesh(max(n // 2, model_parallel), ...)` (the
    model axis kept, the data axis halved), restore the state onto the new
    mesh's shardings and resume. `data_fn(step)` gives the step's batch
    (whole tensors on the devices); the initial parameters are `model.init`
    from seed 0 on the first device."""
    devices = visible_devices() if devices is None else list(devices)
    n = len(devices)
    shape = ShapeConfig("elastic", seq, batch, "train")
    cm = CheckpointManager(ckpt_dir)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10 * steps_each)

    mesh_a = (make_host_mesh(devices) if model_parallel == 1 else
              make_mesh((n // model_parallel, model_parallel), ("data", "model"), devices))
    with use_rules(mesh_a):
        bundle = build_train_step(model, shape, opt_cfg)
    dev = torch.device(devices[0])
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    p, o, _ = place_train_state(bundle, mesh_a, params, init_adam(params))
    p, o, loss_a = _run_steps(bundle, p, o, data_fn, 0, steps_each)
    cm.save(steps_each, {"params": p, "opt": o})
    saved = {"params": p.whole(), "opt": o.whole()}
    del p, o

    # ---- failure: rebuild the mesh from the surviving chips, restore re-sharded ----
    mesh_b = make_elastic_mesh(max(n // 2, model_parallel), model_parallel=model_parallel,
                               chips_per_pod=max(n, 1), devices=devices)
    with use_rules(mesh_b):
        bundle_b = build_train_step(model, shape, opt_cfg)
    resumed_step = cm.latest_step()
    state = cm.restore(resumed_step,
                       {"params": bundle_b.abstract_inputs[0],
                        "opt": bundle_b.abstract_inputs[1]},
                       shardings={"params": bundle_b.in_shardings[0],
                                  "opt": bundle_b.in_shardings[1]})
    p_b, o_b = state["params"], state["opt"]
    restored_equal = all(
        torch.equal(a, b) for got, want in ((p_b.whole(), saved["params"]),
                                            (o_b.whole(), saved["opt"]))
        for a, b in zip(leaves(got), leaves(want)))
    del saved
    p_b, o_b, loss_b = _run_steps(bundle_b, p_b, o_b, data_fn, resumed_step, steps_each)
    logger.info(f"elastic resume: step {resumed_step}, loss {loss_a:.4f} -> {loss_b:.4f}, "
                f"mesh {mesh_a.shape} -> {mesh_b.shape}")
    return ElasticReport(steps_each, steps_each, resumed_step, loss_a, loss_b,
                         dict(mesh_a.shape), dict(mesh_b.shape), restored_equal)
