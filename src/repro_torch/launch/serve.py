"""Serving CLI — a thin command-line front-end over `repro_torch.launch.engine`.

Continuous batching (staggered requests, paged KV cache), on the GPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b --lcd \
        --continuous --no-fused-projections --requests 6 --tokens 16

and at toy size on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --reduced --lcd --continuous --no-fused-projections --device cpu

All engine logic lives in `repro_torch.launch.engine`; this module only parses
flags and reports. The static-batch mode of the JAX package's CLI is not
ported yet: `--continuous` is required.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.engine import (BlockAllocator, EngineConfig, Request,
                                       ServingEngine, build_engine)
from repro_torch.utils import logger, resolve_device

__all__ = ["BlockAllocator", "EngineConfig", "Request", "ServingEngine",
           "build_engine", "main"]


def _run_continuous(args, device) -> list:
    ecfg = EngineConfig(num_slots=args.slots, block_size=args.block_size,
                        num_blocks=args.blocks,
                        max_blocks_per_slot=args.blocks_per_slot,
                        prefill_chunk=args.prefill_chunk,
                        kv_dtype=args.kv_dtype, weight_bits=args.bits,
                        arch=args.arch)
    kv_smooth = None
    if args.kv_dtype == "int8":
        # identity smoothing vectors: always valid; calibrated ones come with
        # calibrate_kv_smooth, which is not ported yet
        from repro_torch.models.config import get_config, reduced
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
        ones = np.ones((cfg.n_layers, cfg.n_kv_heads, cfg.hd), np.float32)
        kv_smooth = (ones, ones)
        logger.info("int8 KV cache: identity smoothing vectors "
                    "(calibration is not ported yet)")
    engine, _ = build_engine(args.arch, use_reduced=args.reduced, lcd=args.lcd,
                             ecfg=ecfg, seed=args.seed, kv_smooth=kv_smooth,
                             fused_projections=args.fused_projections,
                             device=device)
    rng = np.random.default_rng(args.seed)
    cfg = engine.model.cfg
    # staggered submissions: a fresh request every other scheduler step, with
    # varying prompt lengths — the continuous-batching case a static batch
    # cannot serve without padding everyone to the slowest request
    pending = [rng.integers(0, cfg.vocab, rng.integers(4, args.prompt_len + 1))
               for _ in range(args.requests)]
    finished = []
    if device.type == "cuda":
        # build (or find) the kernels now, so that the timing below is serving only
        from repro_torch.kernels import _build
        _build.library()
        if _build.build_seconds is not None:
            logger.info(f"built the CUDA kernels in {_build.build_seconds:.1f}s")
    t0 = time.perf_counter()
    while pending or engine.busy:
        if pending and engine.steps % 2 == 0:
            engine.submit(pending.pop(0), max_new_tokens=args.tokens)
        if engine.busy:
            finished.extend(engine.step())
        else:
            engine.steps += 1          # idle tick: let the next arrival land
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    engine.assert_bounded_traces()
    for r in finished:
        logger.info(f"request {r.rid}: prompt {len(r.prompt)} -> "
                    f"{len(r.out_tokens)} tokens "
                    f"(latency {r.finish_t - r.submit_t:.2f}s, "
                    f"preemptions {r.preemptions})")
    n_tok = sum(len(r.out_tokens) for r in finished)
    logger.info(f"continuous engine on {device}: {len(finished)} requests, "
                f"{n_tok} tokens in {engine.steps} steps, {dt:.2f}s "
                f"({n_tok / max(dt, 1e-9):.1f} tok/s), step widths "
                f"{engine.traces}")
    return finished


def main(argv: Optional[Sequence[str]] = None, device: Optional[str] = None) -> list:
    """Parse flags and serve. `device` (or `--device`) defaults to "cuda";
    asking for a card that is not there raises."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lcd", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="run the paged continuous-batching engine with "
                         "staggered requests (the only mode ported so far)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=48)
    ap.add_argument("--blocks-per-slot", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--kv-dtype", choices=("float", "int8"), default=None,
                    help="paged KV block-pool dtype: int8 stores smoothed "
                         "codes + per-(block-slot, kv-head) scales; default "
                         "follows the model config")
    ap.add_argument("--bits", type=int, choices=(2, 3, 4), default=4,
                    help="uniform LCD weight packing width")
    ap.add_argument("--no-fused-projections", dest="fused_projections",
                    action="store_false",
                    help="serve same-input projection groups (QKV; gate+up) "
                         "through per-projection LUT kernel launches; "
                         "required with --lcd until the fused multi-"
                         "projection kernels are ported")
    ap.add_argument("--device", default=device or "cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.continuous:
        raise NotImplementedError(
            "the static-batch serve() path is not ported yet; add --continuous")
    return _run_continuous(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
