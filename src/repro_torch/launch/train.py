"""Training driver — the port of the JAX package's `launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir build/run1

runs on the card; add `--device cpu` for a rehearsal on the CPU.

  * checkpoint / auto-resume through CheckpointManager (atomic commits, the
    reference's format): the run resumes from the newest committed step and
    saves every `ckpt_every` steps and at the end;
  * straggler watchdog: per-step wall time (host clock, after a
    `torch.cuda.synchronize()` on the card) against its EMA; steps slower
    than `straggler_factor` x EMA are logged and counted;
  * optional int8 gradient compression (error feedback);
  * optional microbatch accumulation.

One device: the port's meshes serve (`launch/engine.py ServingEngine(mesh=)`);
training on a mesh, with the reference's FSDP `embed` rule and its elastic
restarts, is still to come (ROADMAP A7).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.steps import build_train_step
from repro_torch.models.config import get_config, reduced
from repro_torch.models.registry import get_model
from repro_torch.optim.compress import EFState, init_ef
from repro_torch.optim.optimizer import OptConfig, init_adam
from repro_torch.utils import logger, resolve_device


@dataclasses.dataclass
class TrainLoopReport:
    steps_run: int
    final_loss: float
    losses: list
    straggler_steps: int
    resumed_from: Optional[int]


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
          use_reduced: bool = True, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, grad_compress: bool = False,
          microbatch: int = 0, lr: float = 1e-3,
          straggler_factor: float = 3.0, seed: int = 0,
          log_every: int = 10, device="cuda") -> TrainLoopReport:
    """Train `arch` (its `reduced()` form in f32 with `use_reduced`) on the
    synthetic stream from `seed`, on `device` ("cuda" unless the caller asks
    for the CPU; asking for a card that is not there raises)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg, dtype="float32")
    model = get_model(cfg)
    opt_cfg = OptConfig(lr=lr, warmup_steps=min(20, steps // 5), total_steps=steps)
    step_fn = build_train_step(model, opt_cfg, grad_compress=grad_compress,
                               microbatch=microbatch)

    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt_state = init_adam(params)
    ef = init_ef(params) if grad_compress else EFState(None)
    logger.info(f"{arch}: {model.param_count():,} params on {dev}")

    cm = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start, resumed = 0, None
    if cm is not None:
        latest = cm.latest_step()
        if latest is not None:
            state = cm.restore(latest, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = resumed = latest
            logger.info(f"auto-resumed from step {latest}")

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, batch_size=batch,
                                  seed=seed))
    losses = []
    ema = None
    stragglers = 0
    for step in range(start, steps):
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}
        params, opt_state, ef, metrics = step_fn(params, opt_state, ef, b)
        loss = float(metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if ema is not None and dt > straggler_factor * ema:
            stragglers += 1
            logger.warning(f"step {step}: {dt:.2f}s > {straggler_factor}x "
                           f"EMA {ema:.2f}s — straggler flagged")
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        losses.append(loss)
        if step % log_every == 0:
            logger.info(f"step {step}: loss={loss:.4f} "
                        f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s")
        if cm is not None and (step + 1) % ckpt_every == 0:
            cm.save(step + 1, {"params": params, "opt": opt_state})
    if cm is not None:
        cm.save(steps, {"params": params, "opt": opt_state})
    return TrainLoopReport(steps - start, losses[-1] if losses else float("nan"),
                           losses, stragglers, resumed)


def main(argv: Optional[Sequence[str]] = None) -> TrainLoopReport:
    """Parse flags and train; `--device` defaults to "cuda"."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) or "cpu"; no silent fallback')
    args = ap.parse_args(argv)
    rep = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                use_reduced=args.reduced, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, grad_compress=args.grad_compress,
                microbatch=args.microbatch, lr=args.lr, device=args.device)
    logger.info(f"done: final loss {rep.final_loss:.4f} "
                f"({rep.steps_run} steps, {rep.straggler_steps} stragglers)")
    return rep


if __name__ == "__main__":
    main()
