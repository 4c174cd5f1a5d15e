"""Serving CLI — a thin command-line front-end over `repro_torch.launch.engine`.

Static batch (one batch of prompts starts and finishes together), on the GPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b --lcd \
        --batch 4 --prompt-len 64 --tokens 16

Continuous batching (staggered requests, paged KV cache):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b --lcd \
        --continuous --requests 6 --tokens 16

The recurrent and hybrid families (rwkv6-1.6b, gla-1.3b: per-slot state;
zamba2-1.2b: per-slot state and a paged pool for its shared attention) serve
through the same engine:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --lcd \
        --continuous --requests 6 --tokens 16

and so does the audio family (whisper-large-v3, per-slot state): every
request carries synthetic frame embeddings (1, enc_seq, d_model) drawn from
`--seed`, which admission encodes once into the slot's cross-attention K/V:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \
        --lcd --continuous --requests 6 --tokens 16

Self-speculative decoding (the model's own 2-bit clustering drafts K tokens
per verify round; the tokens equal plain greedy decoding's):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b --lcd \
        --continuous --speculative 3 --requests 6 --tokens 16

The engine's production features (continuous mode): `--prefix-cache` shares
the KV blocks of a common prompt prefix between requests (copy-on-write; the
same tokens as without it), `--chunked-prefill` admits a prompt with one
prefill chunk's blocks, `--priority` admits by priority and weighted-fair
tenant share; the demo traffic then opens every other request with one
shared prompt and alternates tenants and priorities:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b --lcd \
        --continuous --prefix-cache --chunked-prefill --priority

`--lcd` compresses the dense weights drawn from `--seed` with the LCD pipeline
(`compress_model`) before serving: `--bits` packs every layer at one width,
`--bits-budget` mixes widths per layer under a global mean, `--describe`
prints the per-layer inventory and exits (continuous mode).

and at toy size on the CPU (`--device cpu`; add `--kv-dtype int8` for the
int8 block pool, whose smoothing vectors are calibrated at start-up):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
        --reduced --lcd --continuous --device cpu

All engine logic lives in `repro_torch.launch.engine`; this module only parses
flags and reports.
"""
from __future__ import annotations

import argparse
import time
import types
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.placement import MeshTree
from repro_torch.launch.engine import (BlockAllocator, EngineConfig, Request,
                                       ServingEngine, build_decode_fns,
                                       build_engine, serve)
from repro_torch.utils import logger, resolve_device

__all__ = ["BlockAllocator", "EngineConfig", "Request", "ServingEngine",
           "build_decode_fns", "build_engine", "serve", "main"]


def _dense_weight_bytes(tree) -> int:
    """Bytes of the dense (unclustered) tensors of a parameter tree."""
    from repro_torch.core.api import is_clustered
    if isinstance(tree, dict):
        return sum(_dense_weight_bytes(v) for v in tree.values())
    if is_clustered(tree) or tree is None:
        return 0
    return tree.numel() * tree.element_size()


def _describe(engine) -> None:
    """Deployment inventory: per-layer packing width and centroid count of the
    compressed target (and of the speculative draft), their packed bytes and
    the bytes left dense (embedding, head, norms; an MoE model's router, and
    its stacked experts, which `compress_model`'s default predicate does not
    cluster), the KV pool dtype, and the bytes of the paged pools (the
    draft's included) beside those of the per-slot recurrent state."""
    from repro_torch.core.clustered_params import packed_weight_bytes
    logger.info(f"serving mesh: {engine.mesh}")
    if engine.mesh.size > 1:
        # every rank holds the same bytes; report what model rank 0 holds
        logger.info("describe: the bytes below are one rank's (model rank 0)")

        def rank0(tree):
            return tree.rank_tree(0) if isinstance(tree, MeshTree) else tree
        engine = types.SimpleNamespace(**{
            **vars(engine), "params": rank0(engine.params),
            "draft_params": rank0(engine.draft_params),
            "caches": {k: rank0(v) for k, v in engine.caches.items()},
            "draft_caches": None if engine.draft_caches is None else {
                k: rank0(v) for k, v in engine.draft_caches.items()}})
    if engine.compress_report is None:
        logger.info("describe: params are not LCD-compressed (run with --lcd)")
    else:
        logger.info("target bits assignment:\n" + engine.compress_report.bits_table())
        logger.info(f"target packed weight bytes: {packed_weight_bytes(engine.params)}")
    logger.info(f"target dense weight bytes: {_dense_weight_bytes(engine.params)}")
    if engine.draft_report is not None:
        logger.info("draft bits assignment:\n" + engine.draft_report.bits_table())
        logger.info(f"draft packed weight bytes: "
                    f"{packed_weight_bytes(engine.draft_params)} (int4 layout "
                    f"would be {packed_weight_bytes(engine.draft_params, nbits=4)})")
    logger.info(f"kv_dtype: {engine.kv_dtype}")
    pool = sum(_dense_weight_bytes(c.get("paged")) for c in (engine.caches,
                                                             engine.draft_caches or {}))
    logger.info(f"sequence caches: paged pool bytes {pool}, slot state bytes "
                f"{_dense_weight_bytes(engine.caches.get('slot'))}")


def _build_kernels(device) -> None:
    """Build (or find) the kernels now, so that the timing after is serving only."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.library()
        if _build.build_seconds is not None:
            logger.info(f"built the CUDA kernels in {_build.build_seconds:.1f}s")


def _run_continuous(args, device) -> list:
    ecfg = EngineConfig(num_slots=args.slots, block_size=args.block_size,
                        num_blocks=args.blocks,
                        max_blocks_per_slot=args.blocks_per_slot,
                        prefill_chunk=args.prefill_chunk,
                        speculative_k=args.speculative,
                        draft_centroids=args.draft_centroids,
                        kv_dtype=args.kv_dtype, weight_bits=args.bits,
                        bits_budget=args.bits_budget, prefix_cache=args.prefix_cache,
                        chunked_prefill=args.chunked_prefill,
                        scheduler="priority" if args.priority else "fcfs",
                        arch=args.arch, data_parallel=args.data_parallel,
                        model_parallel=args.model_parallel)
    engine, _ = build_engine(args.arch, use_reduced=args.reduced, lcd=args.lcd,
                             target_centroids=args.centroids, ecfg=ecfg,
                             seed=args.seed, fused_projections=args.fused_projections,
                             device=device)
    if args.describe:
        _describe(engine)
        return []
    rng = np.random.default_rng(args.seed)
    cfg = engine.model.cfg
    # staggered submissions: a fresh request every other scheduler step, with
    # varying prompt lengths — the continuous-batching case a static batch
    # cannot serve without padding everyone to the slowest request. With
    # --prefix-cache every other request opens with the same "system prompt"
    # so that the demo exercises block reuse; with --priority the requests
    # alternate between two tenants and cycle through three priorities.
    shared = (rng.integers(0, cfg.vocab, max(4, args.prompt_len // 2))
              if args.prefix_cache else None)
    pending = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, args.prompt_len + 1))
        if shared is not None and i % 2 == 0:
            prompt = np.concatenate([shared, prompt])
        pending.append((prompt, dict(tenant=f"tenant{i % 2}", priority=i % 3)
                        if args.priority else {}))
    finished = []
    _build_kernels(device)

    def _frames():
        """An encoder-decoder arch's (whisper's) synthetic frame embeddings,
        one (1, enc_seq, d_model) draw of the run's generator per request,
        encoded once at admission; None for every other arch."""
        if cfg.family != "audio":
            return None
        return rng.normal(size=(1, cfg.enc_seq, cfg.d_model)).astype(np.float32)

    t0 = time.perf_counter()
    while pending or engine.busy:
        if pending and engine.steps % 2 == 0:
            prompt, kw = pending.pop(0)
            engine.submit(prompt, max_new_tokens=args.tokens, frames=_frames(), **kw)
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
    if args.speculative:
        logger.info(f"speculative: {engine.acceptance_summary()}")
    if args.prefix_cache:
        logger.info(f"prefix cache: {engine.prefix_cache_report()}")
    return finished


def main(argv: Optional[Sequence[str]] = None, device: Optional[str] = None):
    """Parse flags and serve. `device` (or `--device`) defaults to "cuda";
    asking for a card that is not there raises. Returns the finished requests
    (continuous mode) or the (batch, tokens) generated tokens (static mode)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lcd", action="store_true",
                    help="LCD-compress the dense weights (compress_model) and "
                         "serve them through the LUT kernels")
    ap.add_argument("--centroids", type=int, default=8,
                    help="target centroid count per layer (capped at 2^bits)")
    ap.add_argument("--batch", type=int, default=4,
                    help="sequences of the static batch")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="run the paged continuous-batching engine with "
                         "staggered requests instead of one static batch")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=48)
    ap.add_argument("--blocks-per-slot", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="draft K tokens per verify round through the "
                         "model's own 2-bit clustering (continuous mode "
                         "only; 0 = off)")
    ap.add_argument("--draft-centroids", type=int, default=4,
                    help="centroid count of the self-draft (4 = 2-bit)")
    ap.add_argument("--kv-dtype", choices=("float", "int8"), default=None,
                    help="paged KV block-pool dtype: int8 stores smoothed "
                         "codes + per-(block-slot, kv-head) scales, the "
                         "smoothing calibrated at start-up; default follows "
                         "the model config (continuous mode only)")
    ap.add_argument("--bits", type=int, choices=(2, 3, 4), default=4,
                    help="uniform LCD weight packing width")
    ap.add_argument("--bits-budget", type=float, default=None,
                    help="per-layer mixed precision under a global "
                         "element-weighted mean-bits cap (e.g. 3.0): "
                         "empirical-Fisher scores keep sensitive layers at "
                         "4-bit and drop the rest to 3/2 (overrides --bits)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-hashed prefix caching with copy-on-write "
                         "block tables: requests sharing a prompt prefix "
                         "share physical KV blocks, the same tokens as "
                         "without it (continuous mode only)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="admit long prompts with one prefill chunk's worth "
                         "of blocks instead of the whole prompt's, so they "
                         "start behind a busy pool (continuous mode only)")
    ap.add_argument("--priority", action="store_true",
                    help="priority / weighted-fair multi-tenant admission in "
                         "place of FCFS; the demo tags requests with "
                         "alternating tenants and priorities (continuous "
                         "mode only)")
    ap.add_argument("--data-parallel", type=int, default=None, metavar="N",
                    help="pin the serving mesh's data axis; the model axis is "
                         "derived from the visible device count. Default: the "
                         "roofline layout search on multi-device hosts "
                         "(continuous mode only)")
    ap.add_argument("--model-parallel", type=int, default=None, metavar="N",
                    help="pin the serving mesh's model (tensor-parallel) "
                         "axis; ClusteredTensor codes/scales and the paged "
                         "pool's kv heads shard across it (continuous mode "
                         "only)")
    ap.add_argument("--no-fused-projections", dest="fused_projections",
                    action="store_false",
                    help="serve same-input projection groups (QKV; gate+up) "
                         "through per-projection LUT kernel launches instead "
                         "of one multi-projection launch; the same bits, for "
                         "perf triage only")
    ap.add_argument("--describe", action="store_true",
                    help="print the deployment inventory (per-layer bits "
                         "assignment, packed weight bytes, kv dtype) and "
                         "exit without serving (continuous mode)")
    ap.add_argument("--device", default=device or "cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.speculative and not args.continuous:
        ap.error("--speculative requires --continuous")
    if args.kv_dtype and not args.continuous:
        ap.error("--kv-dtype applies to the paged engine; add --continuous")
    if args.describe and not args.continuous:
        ap.error("--describe inspects the paged engine; add --continuous")
    for flag, name in ((args.prefix_cache, "--prefix-cache"),
                       (args.chunked_prefill, "--chunked-prefill"),
                       (args.data_parallel is not None, "--data-parallel"),
                       (args.model_parallel is not None, "--model-parallel"),
                       (args.priority, "--priority")):
        if flag and not args.continuous:
            ap.error(f"{name} applies to the paged engine; add --continuous")
    dev = resolve_device(args.device)
    if args.continuous:
        return _run_continuous(args, dev)
    _build_kernels(dev)
    gen, _ = serve(args.arch, use_reduced=args.reduced, lcd=args.lcd,
                   target_centroids=args.centroids, batch=args.batch,
                   prompt_len=args.prompt_len, gen_tokens=args.tokens, seed=args.seed,
                   weight_bits=args.bits, bits_budget=args.bits_budget,
                   fused_projections=args.fused_projections, device=dev)
    return gen


if __name__ == "__main__":
    main()
