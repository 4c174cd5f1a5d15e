"""LCD serving engines: the static-batch path and the continuous-batching
engine with a paged KV cache.

`launch/serve.py` is the CLI over both; this module is the importable API.

Static batch (`serve`, `build_decode_fns`)
    One batch of identical-length prompts starts and finishes together: one
    batched prefill step over the prompts, then one-token decode steps over a
    contiguous (L, B, S, KV, D) cache updated in place, the greedy token
    chosen on the device and all tokens downloaded once at the end. The JAX
    package compiles exactly two computations (prefill and a scanned
    decode). The port runs the prefill eagerly; on the card the decode step
    is captured once as a CUDA graph and replayed, its position and tokens
    in device buffers. It counts the step shapes it ran in the same `traces`
    dict, {"prefill": 1, "decode": 1} per generation.

Continuous batching (`ServingEngine`)
    Real traffic is requests with different prompt lengths, arrival times and
    completion times. The engine holds a fixed number of request SLOTS and a
    pool of fixed-size KV BLOCKS:

      * a free-list `BlockAllocator` hands blocks to slots on demand, so a
        finishing short request frees exactly its blocks for a queued long one;
      * each scheduler `step()` packs prefilling slots (a prompt chunk),
        decoding slots (one token) and idle slots (nothing) into ONE model
        step — per-slot position/length/activity are data, not shapes;
      * the step therefore comes in exactly TWO shapes: token-window width
        `prefill_chunk` (any slot prefilling) and width 1 (pure decode).
        `assert_bounded_traces()` enforces the contract on the set of widths
        the engine has actually run; per-slot math is independent, so engine
        output equals a single-request run.

    Out-of-block pressure is resolved by recompute preemption: the youngest
    running request is evicted back to the queue (its blocks freed) and later
    re-prefills its prompt plus the tokens it had already generated.

    The block pool stores either the model dtype (`EngineConfig.kv_dtype =
    "float"`) or smoothed int8 codes with per-(block-slot, kv-head) scale
    pools ("int8"), the smoothing vectors calibrated by `calibrate_kv_smooth`
    through the static path. The default (None) follows the model's
    cfg.kv_cache_dtype.

    One step is one upload (tokens, lengths, n_new and block tables in a
    single int32 buffer) and one download (the next token of every slot);
    nothing else crosses between host and device inside `step` or inside the
    layer loop. On the card the model step is a CUDA graph per width,
    captured at the width's first step and replayed after it (`_StepGraphs`),
    the counterpart of the JAX package's step jitted per width; on the CPU,
    which a caller has to ask for, it runs eagerly.

    Speculative mode (`EngineConfig.speculative_k = k > 0`) serves a second,
    extreme low-bit model beside the target: `draft_params`, the target's own
    weights re-clustered to 4 centroids and packed at 2 bits
    (core/clustered_params.py make_draft_params), with its own block pool of
    the same geometry that shares the target's block tables and allocator
    grants. A pure-decode step becomes a draft/verify ROUND: k+1 width-1
    draft feeds, then ONE width-(k+1) target verify over [pending, drafts];
    the longest draft prefix the target agrees with is accepted, plus the
    target's own next token, and `lengths` advances by exactly what was
    emitted (the rollback). Greedy output equals the non-speculative
    engine's. A step with a prefilling slot feeds the same window through
    both models. On the card these are three CUDA graphs — the two-model
    prefill step, the k+1 draft feeds, the verify — and a round is one upload
    and one download.

    Production features, as in the reference:
      * prefix caching (`EngineConfig.prefix_cache`): every full block a
        slot has written is published under a position-0-anchored chain
        hash of its tokens (salted by the kv dtype and the layer config);
        an admitted request shares the longest cached block-aligned prefix
        of its feed read-only and prefills only the tail. A write into a
        block another reference still holds copies it first
        (copy-on-write): on the card an in-place copy of the block's rows
        of every pool tensor, eager, on the current stream between two
        replays, so every graph goes on reading the same tensors. Output
        equals the cache-off run's, request for request, within a kv dtype;
      * chunked-prefill admission (`chunked_prefill`): a request is admitted
        with blocks for its first prefill chunk only, the rest grown lazily;
      * the "priority" scheduler: the highest priority first, then the
        tenant with the smallest weighted share of served tokens, then
        arrival, among tenants under `tenant_token_budget`.

    Capability-typed cache protocols, as in the reference: a family serves
    through a paged block pool (the transformers), fixed-size per-slot state
    (rwkv6, gla, whisper: `SlotStateCache`; the slot IS the allocator, so
    admission needs only a free slot and no block arithmetic), or both
    (zamba2 threads its shared-attention pools and its mamba state through
    one step). `self.caches` holds every cache the family declared, keyed by
    kind. Admission zeroes a fresh request's slot rows; an encoder-decoder
    family (whisper, `CAP_ENCODER`) then runs the request's encoder once and
    writes its cross-attention K/V into the slot's rows (`_slot_encode`), so
    every request must come with its `frames`. Where the family declares
    `snapshot` (rwkv6, gla, whisper), `preempt()` copies the slot's rows out
    and re-admission copies them back, so the request resumes without
    recomputing a token or re-running its encoder; everything else
    recomputes. On the card the reset, the encode, the snapshot and the
    restore are eager in-place ops on the current stream between two replays
    (the slot a host int: no sync, and no tensor a graph reads is replaced),
    each one "slot_reset" / "encode" / "snapshot" / "restore" entry in
    `traces`.

With `lcd=True` both paths serve LCD-compressed weights: dense weights (drawn
from `seed`, or passed in) go through `compress_model` (core/api.py) on their
device first, at `weight_bits` or under a `bits_budget`, as in the reference.

Serving meshes, as in the reference: `ServingEngine(mesh=)` (or the
`EngineConfig.data_parallel` / `model_parallel` knobs through `build_engine`,
which otherwise picks the roofline-cheapest layout over a device list the
caller passes, `distributed/layout.py choose_layout`) places the params, the
draft's and both pools on a (data, model) `launch/mesh.py Mesh` (`_place_sharded`):
LUT codes cut by the projections' columns, the pools by kv heads, the slots
by data rank. One process drives every rank: each data rank runs its slots,
each model rank its shards through B1-B5, the parts combine in rank order
(`models/transformer.py _mesh_step`), and the tokens and every step's logits
are the bits of the one-device engine. A one-process mesh's devices must
repeat (`[cuda:0] x n`, built only when asked for); on it the whole mesh
step is one CUDA graph per step shape. Every family serves on a mesh: an MoE layer
routes the step's gathered rows once, each model rank running its experts;
the slot state is cut by heads, its rows shared by the data ranks (each
writes its own slots), and the slot ops act on every part. A one-process
mesh of distinct cards raises NotImplementedError.

A mesh of several cards (or of CPU processes, or of processes sharing one
card over gloo) is a process mesh (`launch/mesh.py ProcessMesh`): one
torch.distributed process per (data, model) coordinate, each holding only
its coordinate's shards (its columns' LUT codes, its kv heads of the pool;
the vocab tables whole) and running only its data rank's slots and its
model rank's B1-B5 launches, the parts combined by the collectives of
`distributed/collectives.py`. Every process runs the same host scheduler
from the same submits (admission, block tables, prefix cache, COW copies
on every replica, chunked prefill, the priority picks); each pool replica
takes every data rank's writes, and after each step rank 0's next tokens
are broadcast and held against every process's own (the lockstep check).
The tokens and every step's logits are the bits of the one-process mesh of
the same shape. The dense and vlm families serve on it, non-speculatively;
the other families and speculative rounds raise NotImplementedError. Its
steps run the eager body on the card as well (`eager_reason`): gloo's
collectives cannot be captured in a CUDA graph.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.api import CT_ARRAY_FIELDS, compress_model, is_clustered
from repro_torch.core.clustered_params import make_draft_params
from repro_torch.core.lut import SUPPORTED_NBITS
from repro_torch.distributed.collectives import check_lockstep, check_same_tree
from repro_torch.distributed.placement import MeshTree, place
from repro_torch.distributed.sharding import parts_on, use_rules
from repro_torch.kernels.ops import add_launches, capture_launches
from repro_torch.launch.mesh import (init_process_mesh, is_process_mesh, make_mesh,
                                     refuse_process_mesh, require_one_device,
                                     visible_devices)
from repro_torch.models.config import get_config, reduced
from repro_torch.models.registry import (CAP_ENCODER, CAP_INT8_KV, CAP_PAGED,
                                         CAP_PREFIX_CACHE, CAP_SLOT_STATE,
                                         CAP_SPECULATIVE, Model, arch_capabilities,
                                         get_model)
from repro_torch.utils import cdiv, human_bytes, logger, resolve_device


# ---------------------------------------------------------------------------
# Static-batch path: one prefill step + a loop of decode steps
# ---------------------------------------------------------------------------

def build_decode_fns(model, cfg, gen_tokens: int):
    """(prefill_fn, decode_fn, traces): the static path's two computations.

    prefill(params, cache, prompt (B, P) int32) -> (first token (B, 1) int32,
    cache); decode(params, cache, first_tok) -> (tokens (B, gen_tokens) int32
    on the device, cache), the first column being `first_tok`. Nothing is
    read back to the host inside either. On the card the decode is one
    captured step replayed: its first step runs eagerly as the capture's
    warm-up, then the step is captured over its token, position and output
    buffers and replayed for the other gen_tokens - 1 (the counterpart of
    the JAX package's scanned decode). `traces` counts the distinct input
    shapes each has run, the counterpart of the JAX package's trace counts:
    {"prefill": 1, "decode": 1} after a generation."""
    traces = {"prefill": 0, "decode": 0}
    shapes = {"prefill": set(), "decode": set()}

    def count(name, shape):
        shapes[name].add(tuple(shape))
        traces[name] = len(shapes[name])

    def greedy(logits):
        return torch.argmax(logits[..., :cfg.vocab], dim=-1)[:, None].to(torch.int32)

    @torch.no_grad()
    def prefill(params, cache, prompt):
        count("prefill", prompt.shape)
        logits, cache = model.decode(params, cache, {"tokens": prompt, "pos": 0})
        return greedy(logits), cache

    @torch.no_grad()
    def decode_step(params, cache, tok, out, i):
        """Step i, a device index: column i of `out` is the step's input
        token, whose greedy successor then replaces it in `tok`; the cache's
        position advances on the device."""
        out.index_copy_(1, i, tok)
        logits, _ = model.decode(params, cache, {"tokens": tok, "pos": cache["pos"]})
        tok.copy_(greedy(logits))
        i.add_(1)

    @torch.no_grad()
    def decode(params, cache, first_tok):
        count("decode", first_tok.shape)
        dev = first_tok.device
        tok = first_tok.clone()
        out = torch.empty((tok.shape[0], gen_tokens), dtype=torch.int32, device=dev)
        i = torch.zeros(1, dtype=torch.int64, device=dev)
        step = functools.partial(decode_step, params, cache, tok, out, i)
        if dev.type != "cuda" or gen_tokens < 2:
            for _ in range(gen_tokens):
                step()
            return out, cache
        _, graph = _warm_up_and_capture(step, torch.cuda.Stream(dev),
                                        torch.cuda.graph_pool_handle())
        for _ in range(gen_tokens - 1):
            graph.replay()
        return out, cache

    return prefill, decode, traces


# ---------------------------------------------------------------------------
# CUDA graphs of a step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _CapturedStep:
    """A step body captured as a CUDA graph: `out` is what the captured body
    returned (the graph's static output), `launches` the kernel launches one
    replay makes, `capture_s` the host seconds the capture and the graph's
    instantiation took."""
    graph: Any
    out: Any
    launches: Dict[str, int]
    capture_s: float

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)


def _warm_up_and_capture(body, stream, pool):
    """(what the warm-up returned, the _CapturedStep): `body` runs once
    eagerly on the side `stream` (the warm-up PyTorch asks of a capture; it
    also builds the kernels and the cuBLAS state of that stream) and is then
    captured on the same stream into the memory `pool`. No device
    synchronisation: the side stream waits for the current one, and the
    current one for it. A capture or instantiation that fails raises, with
    the body's own error where the body failed; nothing falls back to the
    eager body."""
    cur = torch.cuda.current_stream()
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        first = body()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with capture_launches() as launches:
            graph.capture_begin(pool=pool)
            try:
                out = body()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()        # end the broken capture; re-raise the cause
                raise
            graph.capture_end()
        captured = _CapturedStep(graph, out, launches, time.perf_counter() - t0)
    cur.wait_stream(stream)
    return first, captured


def _model_and_params(arch, *, use_reduced, n_layers, fused_projections, lcd,
                      target_centroids, weight_bits, bits_budget, seed, params, dev):
    """(model, params, compress report or None) for an entry point. Without
    `params`, dense weights are drawn from `seed` on `dev`. With `lcd=True`
    and no clustered leaf among them, the dense weights are compressed where
    they lie, as the reference does: `compress_model` at
    min(target_centroids, 2**weight_bits) centroids and `weight_bits` packing,
    or under `bits_budget`."""
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg, dtype="float32")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        if cfg.is_encdec:                 # an encoder-decoder: both stacks
            cfg = dataclasses.replace(cfg, n_enc_layers=n_layers)
    if cfg.fused_projections != fused_projections:
        # --no-fused-projections: per-projection LUT launches; the same bits
        cfg = dataclasses.replace(cfg, fused_projections=fused_projections)
    model = get_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    report = None
    if lcd and not _has_clustered(params):
        dense_bytes = _tree_bytes(params)
        params, report = compress_model(
            params, target_centroids=min(target_centroids, 1 << weight_bits),
            nbits=weight_bits, bits_budget=bits_budget, device=dev)
        logger.info("LCD: " + report.summary())
        logger.info(f"weights: {human_bytes(dense_bytes)} dense -> "
                    f"{human_bytes(_tree_bytes(params))} clustered")
    return model, params, report


def serve(arch: str, *, use_reduced: bool = True, lcd: bool = False,
          target_centroids: int = 8, batch: int = 4, prompt_len: int = 16,
          gen_tokens: int = 32, seed: int = 0, params=None, greedy=True,
          stats: Optional[Dict[str, Any]] = None, weight_bits: int = 4,
          bits_budget: Optional[float] = None,
          fused_projections: bool = True, device="cuda"):
    """Static-batch generation: `gen_tokens` per sequence for one batch of
    random prompts of `prompt_len` tokens (from `seed`); returns (tokens
    (B, gen) numpy, params).

    With `lcd=True`, dense params (drawn from `seed` when not given) are
    LCD-compressed first: `weight_bits` is the uniform packing width,
    `bits_budget` the Fisher-scored per-layer mix under a global mean, and
    `stats` then receives `bits_assignment` and `mean_packed_bits`. Decoding
    is greedy. Pass a dict as `stats` to receive timing and trace telemetry.
    `device` is "cuda" unless the caller asks for the CPU. For staggered
    multi-request traffic use `ServingEngine` instead."""
    dev = resolve_device(device)
    model, params, report = _model_and_params(
        arch, use_reduced=use_reduced, n_layers=None,
        fused_projections=fused_projections, lcd=lcd,
        target_centroids=target_centroids, weight_bits=weight_bits,
        bits_budget=bits_budget, seed=seed, params=params, dev=dev)
    if stats is not None and report is not None:
        stats["bits_assignment"] = dict(report.bits_assignment)
        stats["mean_packed_bits"] = report.mean_packed_bits
    cfg = model.cfg
    cache = model.init_cache(batch, prompt_len + gen_tokens, device=dev)
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(dev)
    prefill, decode, traces = build_decode_fns(model, cfg, gen_tokens)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    first_tok, cache = prefill(params, cache, prompt)
    sync()
    t1 = time.perf_counter()
    gen, cache = decode(params, cache, first_tok)
    gen = gen.cpu().numpy()
    t2 = time.perf_counter()

    dt = t2 - t0
    tok_s = gen.shape[1] * batch / max(t2 - t1, 1e-9)
    logger.info(f"{arch}{' +LCD' if lcd else ''} on {dev}: generated "
                f"{gen.shape[1]} tokens x {batch} seqs in {dt:.2f}s "
                f"(prefill {t1 - t0:.2f}s, decode {t2 - t1:.2f}s, "
                f"{tok_s:.1f} tok/s) — traces: {traces}")
    if stats is not None:
        stats.update(tokens_per_s=tok_s, prefill_s=t1 - t0, decode_s=t2 - t1,
                     total_s=dt, traces=dict(traces),
                     gen_tokens=int(gen.shape[1]), batch=batch)
    return gen, params


# ---------------------------------------------------------------------------
# Paged-block allocator (refcounted, content-hash-indexed)
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Refcounted free-list allocator over the physical KV block pool, with a
    content-hash index for prefix caching.

    Invariants:

      * every block id is either on the free list (refcount 0) or referenced
        (refcount >= 1) — `num_free + referenced == num_blocks` always;
      * a reference is a slot's block-table entry OR the hash index's own
        entry, so `refcount(b) == holders(b) + (1 if b is indexed)` and a
        hash-index entry can NEVER point at a freed block (the index's
        reference keeps it allocated);
      * `alloc` is all-or-nothing (no partial grants) and may reclaim
        cache-only blocks (refcount 1, held solely by the index) in LRU
        order to satisfy a grant;
      * `free` decrements; a block returns to the free list exactly when its
        refcount hits zero, exactly once. Freeing an unallocated block or an
        out-of-range id raises `ValueError` naming the block id.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: collections.deque = collections.deque(range(num_blocks))
        self._refcount: List[int] = [0] * num_blocks
        # content hash -> block id; the index HOLDS one reference per entry.
        # An OrderedDict doubles as the LRU order for cache-only reclaim
        # (move_to_end on every hit/registration).
        self._hash_index: "collections.OrderedDict" = collections.OrderedDict()
        self._block_hash: List[Optional[int]] = [None] * num_blocks

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        return len(self._hash_index)

    def refcount(self, b: int) -> int:
        return self._refcount[b]

    def _check_id(self, op: str, b) -> None:
        if not isinstance(b, (int, np.integer)) or not 0 <= b < self.num_blocks:
            raise ValueError(
                f"BlockAllocator.{op}: block id {b!r} out of range "
                f"[0, {self.num_blocks})")

    def _reclaimable(self) -> int:
        """Cache-only blocks (refcount 1, sole holder is the index) that
        `alloc` may evict from the prefix cache to satisfy a grant."""
        return sum(1 for h, b in self._hash_index.items()
                   if self._refcount[b] == 1)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free) + self._reclaimable():
            return None
        while len(self._free) < n:
            self._evict_cached()
        out = []
        for _ in range(n):
            b = self._free.popleft()
            self._refcount[b] = 1
            out.append(b)
        return out

    def share(self, b: int) -> int:
        """Add a reference to an allocated block (read-only sharing across
        slots — prefix caching's grant path). Returns the new refcount."""
        self._check_id("share", b)
        if self._refcount[b] == 0:
            raise ValueError(
                f"BlockAllocator.share: block {b} is free — only an "
                f"allocated block can be shared")
        self._refcount[b] += 1
        return self._refcount[b]

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block id; a block whose refcount hits zero
        returns to the free list. Raises ValueError (naming the id) on an
        out-of-range id or a refcount underflow (double free / free of a
        never-allocated block)."""
        for b in blocks:
            self._check_id("free", b)
            if self._refcount[b] == 0:
                raise ValueError(
                    f"BlockAllocator.free: block {b} is not allocated "
                    f"(double free or refcount underflow)")
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                # cannot still be hash-indexed: the index holds a reference,
                # so an indexed block bottoms out at refcount 1
                self._free.append(b)

    # -- prefix-cache index --------------------------------------------------

    def register(self, b: int, h: int) -> bool:
        """Publish allocated block `b` under content hash `h`. The index
        takes its own reference, so the entry keeps the block alive after
        every slot lets go. First writer wins: an already-indexed hash is
        left pointing at its existing block (returns False)."""
        self._check_id("register", b)
        if self._refcount[b] == 0:
            raise ValueError(
                f"BlockAllocator.register: block {b} is free — only an "
                f"allocated block can enter the hash index")
        if h in self._hash_index:
            self._hash_index.move_to_end(h)
            return False
        if self._block_hash[b] is not None:
            # block already published under some other hash — a second entry
            # would take a second index reference and orphan the first one;
            # first publication wins
            return False
        self._hash_index[h] = b
        self._block_hash[b] = h
        self._refcount[b] += 1
        return True

    def lookup(self, h: int) -> Optional[int]:
        """Block id cached under hash `h`, or None. A hit refreshes the
        entry's LRU position (it just proved useful)."""
        b = self._hash_index.get(h)
        if b is not None:
            self._hash_index.move_to_end(h)
        return b

    def _evict_cached(self) -> bool:
        """Drop the least-recently-used cache-only index entry, returning its
        block to the free list. Blocks a slot still holds (refcount > 1) are
        never touched."""
        for h, b in self._hash_index.items():
            if self._refcount[b] == 1:
                del self._hash_index[h]
                self._block_hash[b] = None
                self._refcount[b] = 0
                self._free.append(b)
                return True
        return False


# ---------------------------------------------------------------------------
# Requests and engine configuration
# ---------------------------------------------------------------------------

QUEUED, RUNNING, FINISHED, CANCELLED = ("queued", "running", "finished",
                                        "cancelled")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (P,) int32
    max_new_tokens: int
    state: str = QUEUED
    slot: Optional[int] = None
    blocks: List[int] = dataclasses.field(default_factory=list)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    fed: int = 0                       # tokens of `feed` already in the cache
    preemptions: int = 0
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    # multi-tenant scheduling: admission weight / budget key and the
    # intra-tenant priority (higher admits first)
    tenant: str = "default"
    priority: int = 0
    # prefix caching: prompt tokens served from shared cached blocks instead
    # of re-prefilled, and the chain hashes of this request's full blocks
    # registered so far (position-0-anchored, block-granular)
    cached_tokens: int = 0
    hash_chain: List[int] = dataclasses.field(default_factory=list)
    # streaming: called as on_token(request, token) for every emitted token
    on_token: Optional[Any] = None
    # tokens counted against this request's tenant budget while admitted
    inflight_tokens: int = 0
    # speculative mode: accepted draft tokens per verify round (0..k each;
    # round i emits accept_lens[i] + 1 tokens, a budget cap included)
    accept_lens: List[int] = dataclasses.field(default_factory=list)
    # encoder-decoder (CAP_ENCODER): the request's precomputed frame
    # embeddings (1, enc_seq, d_model) in the model dtype on the engine's
    # device, encoded ONCE at admission into the slot's cross-attention state
    frames: Optional[Any] = None
    # snapshot preemption: the slot's state rows ({name: [a tensor a part]}) and its
    # length when it was preempted; re-admission restores both instead of
    # re-prefilling
    snapshot: Optional[Dict[str, Any]] = None
    snap_len: int = 0

    # tokens to (re)prefill this running stint, SNAPSHOTTED at admission:
    # the prompt plus anything generated before a preemption. Tokens decoded
    # after admission are fed one at a time, not appended here — otherwise a
    # decoding request would look permanently "prefilling" and pin the step
    # at the wide shape.
    feed: Optional[np.ndarray] = None

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens

    @property
    def prefilling(self) -> bool:
        return self.feed is not None and self.fed < len(self.feed)

    def resume_feed(self) -> np.ndarray:
        """prompt + already-generated tokens — after a recompute preemption
        the generated tokens are re-ingested as prompt so greedy decoding
        resumes where it left off."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)])


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_slots: int = 4                # concurrent sequences per step
    block_size: int = 16              # tokens per KV block
    num_blocks: int = 64              # physical pool size (all slots share it)
    max_blocks_per_slot: int = 16     # block-table width (max seq / block_size)
    prefill_chunk: int = 16           # token-window width of the mixed step
    # speculative decoding: tokens drafted by the 2-bit LCD draft per verify
    # round; 0 = off
    speculative_k: int = 0
    draft_centroids: int = 4          # 2-bit self-draft
    # KV block-pool dtype: "float" keeps blocks in the model dtype; "int8"
    # stores smoothed int8 codes + per-(block-slot, kv-head) scale pools.
    # None follows the model's cfg.kv_cache_dtype.
    kv_dtype: Optional[str] = None
    # weight bit-width policy: weight_bits is the uniform packing width;
    # bits_budget, when set, asks for per-layer mixed precision under that
    # global element-weighted mean.
    weight_bits: int = 4
    bits_budget: Optional[float] = None
    # prefix caching: content-hashed block reuse with copy-on-write block
    # tables; output equals a cache-off run's within a kv dtype
    prefix_cache: bool = False
    # chunked-prefill admission: admit a prompt once blocks for its FIRST
    # prefill chunk are grantable (later chunks grow the table lazily)
    chunked_prefill: bool = False
    # admission policy: "fcfs" is strict arrival order; "priority" picks by
    # (priority desc, weighted-fair tenant share asc, arrival) among tenants
    # under their token budget
    scheduler: str = "fcfs"
    # tenant -> fair-share weight (unlisted tenants weigh 1.0); "priority" only
    tenant_weights: Optional[Dict[str, float]] = None
    # max concurrently admitted tokens (feed + generation budget) per tenant;
    # None = unbounded. "priority" only
    tenant_token_budget: Optional[int] = None
    # architecture binding: when set, capability-dependent knobs are
    # validated EAGERLY against the arch's family capabilities at config
    # construction.
    arch: Optional[str] = None
    # requested (data, model) axis sizes of the serving mesh. None = let
    # build_engine pick (the roofline layout search on multi-device hosts,
    # one device otherwise). A knob that disagrees with the mesh an engine
    # is constructed on fails at engine init with both values named.
    data_parallel: Optional[int] = None
    model_parallel: Optional[int] = None

    def __post_init__(self):
        """Eager validation: a bad knob fails at config construction with the
        allowed values spelled out, not deep inside cache init."""
        if self.kv_dtype not in (None, "float", "int8"):
            raise ValueError(
                f"EngineConfig.kv_dtype must be None (follow the model "
                f"config), 'float' or 'int8'; got {self.kv_dtype!r}")
        if self.weight_bits not in SUPPORTED_NBITS:
            raise ValueError(
                f"EngineConfig.weight_bits must be one of {SUPPORTED_NBITS}; "
                f"got {self.weight_bits!r}")
        if self.bits_budget is not None and not (
                min(SUPPORTED_NBITS) <= self.bits_budget <= max(SUPPORTED_NBITS)):
            raise ValueError(
                f"EngineConfig.bits_budget must lie in "
                f"[{min(SUPPORTED_NBITS)}, {max(SUPPORTED_NBITS)}] (global "
                f"mean packed bits); got {self.bits_budget!r}")
        if self.speculative_k < 0:
            raise ValueError(
                f"EngineConfig.speculative_k must be >= 0; got "
                f"{self.speculative_k}")
        if not 2 <= self.draft_centroids <= 16:
            raise ValueError(
                f"EngineConfig.draft_centroids must lie in [2, 16] (sub-byte "
                f"codes); got {self.draft_centroids}")
        if self.num_blocks < self.max_blocks_per_slot:
            raise ValueError(
                f"EngineConfig.num_blocks ({self.num_blocks}) must be >= "
                f"max_blocks_per_slot ({self.max_blocks_per_slot}) or no "
                f"request can ever be fully admitted")
        if self.scheduler not in ("fcfs", "priority"):
            raise ValueError(
                f"EngineConfig.scheduler must be 'fcfs' or 'priority'; got "
                f"{self.scheduler!r}")
        if self.tenant_token_budget is not None and self.tenant_token_budget <= 0:
            raise ValueError(
                f"EngineConfig.tenant_token_budget must be positive (max "
                f"concurrently admitted tokens per tenant); got "
                f"{self.tenant_token_budget!r}")
        if self.tenant_weights is not None and any(
                w <= 0 for w in self.tenant_weights.values()):
            raise ValueError(
                f"EngineConfig.tenant_weights must all be positive; got "
                f"{self.tenant_weights!r}")
        for knob in ("data_parallel", "model_parallel"):
            v = getattr(self, knob)
            if v is not None and (not isinstance(v, int) or v < 1):
                raise ValueError(
                    f"EngineConfig.{knob} must be a positive int (mesh axis "
                    f"size) or None (auto layout); got {v!r}")
        if self.arch is not None:
            caps = arch_capabilities(self.arch)  # ValueError when unknown
            if self.speculative_k and CAP_SPECULATIVE not in caps:
                raise ValueError(
                    f"EngineConfig.speculative_k > 0 needs the 'speculative' "
                    f"capability; arch {self.arch!r} has {sorted(caps)}")
            if self.prefix_cache and CAP_PREFIX_CACHE not in caps:
                raise ValueError(
                    f"EngineConfig.prefix_cache=True needs the 'prefix_cache' "
                    f"capability; arch {self.arch!r} has {sorted(caps)}")
            if self.kv_dtype == "int8" and CAP_INT8_KV not in caps:
                raise ValueError(
                    f"EngineConfig.kv_dtype='int8' needs the 'int8_kv' "
                    f"capability; arch {self.arch!r} has {sorted(caps)}")

    @property
    def max_seq(self) -> int:
        return self.max_blocks_per_slot * self.block_size


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------

class ServingEngine:
    """Continuous-batching scheduler over the paged decode path.

    Slot lifecycle: submit -> QUEUED -> (admit: slot + prompt blocks granted)
    -> RUNNING prefill (chunked) -> RUNNING decode (1 token per step, blocks
    allocated lazily at block-size boundaries) -> FINISHED (slot and blocks
    freed, immediately reusable by the queue).

        engine = ServingEngine(model, params, EngineConfig(...), device="cuda")
        engine = ServingEngine(model, params, ecfg, mesh=make_mesh(
            (1, 2), ("data", "model"), ["cuda:0"] * 2))   # two model ranks
        engine.submit(prompt, max_new_tokens=32)
        finished = engine.run()          # drive until queue + slots drain
        engine.assert_bounded_traces()   # bounded set of step shapes

    `params` and the KV pools live on `device` (on a mesh, placed on its
    devices and `device` ignored); the pools are updated in place by every
    step.

    Speculative mode (ecfg.speculative_k > 0) also takes the 2-bit draft
    clustering as `draft_params` (core/clustered_params.py
    make_draft_params); a second block pool mirrors the target's and reuses
    the SAME block tables and allocator grants, so one reservation covers
    both models.
    """

    def __init__(self, model: Model, params, ecfg: Optional[EngineConfig] = None,
                 mesh=None, clock=time.perf_counter, draft_params=None,
                 kv_smooth=None, device="cuda"):
        ecfg = EngineConfig() if ecfg is None else ecfg
        if mesh is None:
            self.device = resolve_device(device)
            mesh = make_mesh((1, 1), ("data", "model"), [self.device])
        else:
            if tuple(mesh.axis_names) != ("data", "model"):
                raise NotImplementedError(
                    f"ServingEngine: the serving mesh's axes must be ('data', 'model'); "
                    f"got {mesh.axis_names}")
            require_one_device(mesh, "ServingEngine")
            self.device = mesh.lead_device
        self.mesh = mesh
        # mesh-knob agreement: a config that requested axis sizes must match
        # the mesh this engine actually serves on
        axes = dict(self.mesh.shape)
        for knob, axis in (("data_parallel", "data"), ("model_parallel", "model")):
            want = getattr(ecfg, knob)
            if want is not None and want != axes.get(axis, 1):
                raise ValueError(
                    f"EngineConfig.{knob}={want} does not match the engine "
                    f"mesh's '{axis}' axis ({axes.get(axis, 1)}); mesh shape "
                    f"is {axes}")
        caps = model.capabilities
        if CAP_PAGED not in caps and CAP_SLOT_STATE not in caps:
            raise ValueError(
                f"family '{model.cfg.family}' publishes no serving cache "
                f"protocol (needs 'paged' or 'slot_state'); has {sorted(caps)}")
        self.has_paged = CAP_PAGED in caps
        self.has_slot = CAP_SLOT_STATE in caps
        self.spec_k = ecfg.speculative_k
        family = model.cfg.family
        if model.cfg.n_experts:
            refuse_process_mesh(mesh, f"serving the MoE family ({family})", "A7.3")
        if self.has_slot:
            refuse_process_mesh(mesh, f"serving the slot-state family '{family}'", "A7.3")
        if self.spec_k:
            refuse_process_mesh(mesh, "speculative rounds (speculative_k > 0)", "A7.4")
            if CAP_SPECULATIVE not in caps:
                raise ValueError(
                    f"EngineConfig.speculative_k > 0 needs the 'speculative' "
                    f"capability; family '{model.cfg.family}' has {sorted(caps)}")
            if draft_params is None:
                raise ValueError(
                    "speculative decoding needs draft_params (see "
                    "core/clustered_params.py make_draft_params)")
        self.draft_params = draft_params
        # the RESOLVED pool dtype: an explicit knob wins, else follow the
        # model config
        if CAP_INT8_KV in caps:
            self.kv_dtype = ecfg.kv_dtype or (
                "int8" if model.cfg.kv_cache_dtype == "int8" else "float")
        else:
            if ecfg.kv_dtype == "int8":
                raise ValueError(
                    f"EngineConfig.kv_dtype='int8' needs the 'int8_kv' "
                    f"capability; family '{model.cfg.family}' has "
                    f"{sorted(caps)}")
            self.kv_dtype = "float"
        if kv_smooth is not None and self.kv_dtype != "int8":
            raise ValueError("kv_smooth only applies to the int8 KV cache")
        if ecfg.prefix_cache and CAP_PREFIX_CACHE not in caps:
            raise ValueError(
                f"EngineConfig.prefix_cache=True needs the 'prefix_cache' "
                f"capability; family '{model.cfg.family}' has {sorted(caps)}")
        self.model, self.params, self.ecfg = model, params, ecfg
        # the CompressReport of the params, when build_engine compressed them
        self.compress_report = None
        self.clock = clock
        self.alloc = BlockAllocator(ecfg.num_blocks)
        self.slots: List[Optional[Request]] = [None] * ecfg.num_slots
        # unallocated entries point at block 0; reads there are masked by
        # lengths, writes by n_new — never observable
        self.block_tables = np.zeros(
            (ecfg.num_slots, ecfg.max_blocks_per_slot), np.int32)
        self.lengths = np.zeros(ecfg.num_slots, np.int32)
        self.queue: collections.deque = collections.deque()
        self.finished: List[Request] = []
        # prefix cache: chain hashes are salted with the kv dtype and the
        # layer config, so two engines only ever share content computed by
        # an identical paged stack
        self._prefix_salt = hash((self.kv_dtype, repr(model.cfg)))
        # tenant accounting for the "priority" scheduler: tokens currently
        # admitted (feed + generation budget) and total tokens served, per
        # tenant; the weighted-fair share is served / weight
        self._tenant_inflight: Dict[str, int] = {}
        self._tenant_served: Dict[str, int] = {}
        # prefix-cache telemetry
        self.cache_stats: Dict[str, int] = {
            "cached_tokens": 0,        # prompt tokens served from the cache
            "shared_block_grants": 0,  # block grants satisfied by sharing
            "fresh_block_grants": 0,   # block grants satisfied by alloc
            "cow_copies": 0,           # copy-on-write block copies
            "registered_blocks": 0,    # blocks published to the hash index
        }

        def pools():
            return model.init_seq_caches(
                num_blocks=ecfg.num_blocks, block_size=ecfg.block_size,
                num_slots=ecfg.num_slots, max_seq=ecfg.max_seq,
                kv_dtype=self.kv_dtype if self.has_paged else None,
                device=self.device)
        self.caches = pools()
        # the draft's own K/V pool (draft weights produce other K/V), with the
        # same geometry, block ids and kv dtype as the target's
        self.draft_caches = pools() if self.spec_k else None
        if kv_smooth is not None:
            # calibrated smoothing vectors; identity vectors are always valid
            # (smoothing is a quantization-quality knob, not a correctness
            # one). The draft pool takes the same values, in tensors of its own.
            k_sm, v_sm = kv_smooth
            for caches in (self.caches, self.draft_caches):
                if caches is None:
                    continue
                pool = caches["paged"]
                for name, sm in (("k_smooth", k_sm), ("v_smooth", v_sm)):
                    sm = torch.tensor(np.asarray(sm, np.float32))
                    if sm.shape != pool[name].shape:
                        raise ValueError(
                            f"kv_smooth: {name} must be {tuple(pool[name].shape)} "
                            f"(layers, kv heads, head dim); got {tuple(sm.shape)}")
                    pool[name] = sm.to(self.device).contiguous()
        pool_bytes = (_tree_bytes(self.caches.get("paged"))
                      + _tree_bytes((self.draft_caches or {}).get("paged")))
        slot_bytes = _tree_bytes(self.caches.get("slot"))
        logger.info(f"engine: {ecfg.num_slots} slots, "
                    + (f"{2 if self.spec_k else 1} x {ecfg.num_blocks} x "
                       f"{ecfg.block_size}-token {self.kv_dtype} KV blocks "
                       f"({human_bytes(pool_bytes)})" if self.has_paged else "no KV blocks")
                    + (f", slot state {human_bytes(slot_bytes)}" if self.has_slot else "")
                    + f" on {self.device}")
        # the step shapes this engine has run, with how often — widths T
        # normally, (role, width) in speculative mode ("prefill", "draft",
        # "verify"); the counted form of the reference's bounded-trace contract
        self.traces: Dict[Any, int] = {}
        self._next_rid = 0
        self.steps = 0
        self.spec_rounds = 0
        # the CompressReport of the draft, when build_engine made it
        self.draft_report = None
        # the layout search's report, when build_engine chose the mesh
        self.layout_report = None
        self._place_sharded()
        # on the card the model step (the whole mesh step) is captured per
        # width, after the pools above are final; the CPU runs it eagerly,
        # and so does a process mesh: its collectives cannot be captured
        # (gloo's at all; NCCL's capture waits for a host with several cards)
        self.eager_reason: Optional[str] = None
        if self.device.type != "cuda":
            self.eager_reason = "cpu: no CUDA graphs"
        elif is_process_mesh(self.mesh):
            self.eager_reason = (f"process mesh ({self.mesh.backend}): its collectives are "
                                 f"not captured in a CUDA graph; every kernel still "
                                 f"launches on the card")
            logger.info(f"engine: eager steps on the card: {self.eager_reason}")
        self._graphs = _StepGraphs() if self.eager_reason is None else None

    def _place_sharded(self) -> None:
        """Place the params, the draft's and every cache on the mesh (a 1 x 1
        mesh keeps them as they are; a process mesh, only this process's
        coordinate's shards). Weights by the serving names
        (`distributed/layout.py serving_names`: ClusteredTensor codes cut by
        the projections' output columns, smoothing vectors like the input
        dims, an MoE layer's stacked experts on their experts with every
        field that carries them, codebooks and the vocab tables whole);
        caches by the family's cache names (kv heads on the model axis: each
        rank holds its kv-head shard of EVERY block, so block tables stay
        valid everywhere; slot state by heads), every data rank holding the
        same cache tensors."""
        if self.mesh.size == 1:
            return
        from repro_torch.distributed.layout import (SERVE_RULES, cache_shardings,
                                                    serving_names)
        from repro_torch.distributed.sharding import auto_shard
        with use_rules(self.mesh, SERVE_RULES, fsdp=False):
            names = serving_names(self.model)
            self.params = place(self.params, auto_shard(self.params, names), self.mesh)
            if self.draft_params is not None:
                self.draft_params = place(self.draft_params,
                                          auto_shard(self.draft_params, names), self.mesh)
            for attr in ("caches", "draft_caches"):
                caches = getattr(self, attr)
                if caches is not None:
                    shard = cache_shardings(self.model, caches)
                    setattr(self, attr, {kind: place(c, shard[kind], self.mesh, writable=True)
                                         for kind, c in caches.items()})

    @property
    def draft_cache(self):
        warnings.warn(
            "ServingEngine.draft_cache is deprecated; use "
            "engine.draft_caches['paged']", DeprecationWarning, stacklevel=2)
        return None if self.draft_caches is None else self.draft_caches.get("paged")

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, tenant: str = "default",
               priority: int = 0, on_token=None, frames=None) -> Request:
        """Queue a request. `tenant` / `priority` feed the "priority"
        scheduler; `on_token(request, token)` streams every emitted token as
        it is decoded (a speculative round streams each accepted token in
        order). An encoder-decoder family (CAP_ENCODER) REQUIRES `frames`,
        the request's precomputed frame embeddings (enc_seq, d_model) or (1,
        enc_seq, d_model), a numpy array or a tensor, cast to the model dtype
        and kept on the engine's device until admission encodes them; any
        other family refuses them."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cfg = self.model.cfg
        if self.model.supports(CAP_ENCODER):
            if frames is None:
                raise ValueError(
                    f"family '{cfg.family}' is encoder-decoder: submit() needs "
                    f"`frames` (1, enc_seq, d_model)")
            frames = torch.as_tensor(frames)
            if frames.ndim == 2:
                frames = frames[None]
            want = (1, cfg.enc_seq, cfg.d_model)
            if tuple(frames.shape) != want:
                raise ValueError(
                    f"frames must be {want} (one request's encoder input); got "
                    f"{tuple(frames.shape)}")
            frames = frames.to(torch.float32).to(device=self.device, dtype=cfg.torch_dtype)
        elif frames is not None:
            raise ValueError(
                f"family '{cfg.family}' has no encoder; submit() got unexpected "
                f"`frames`")
        # a speculative round writes up to k tokens past the accepted length
        # before rolling back, so a request needs k tokens of headroom
        need = len(prompt) + max_new_tokens + self.spec_k
        if need > self.ecfg.max_seq:
            raise ValueError(
                f"request needs {need} tokens (incl. speculative headroom "
                f"{self.spec_k}); engine max_seq is {self.ecfg.max_seq} "
                f"(max_blocks_per_slot * block_size)")
        r = Request(self._next_rid, prompt, max_new_tokens, submit_t=self.clock(),
                    tenant=tenant, priority=priority, on_token=on_token, frames=frames)
        self._next_rid += 1
        self.queue.append(r)
        return r

    def cancel(self, r: Request) -> bool:
        """Abort a queued or running request. A running request's slot and
        blocks are released immediately; frees go through the refcounted
        allocator, so blocks other slots or the prefix-cache index still
        reference survive untouched. Returns False if the request already
        finished or was already cancelled."""
        if r.state == QUEUED:
            self.queue.remove(r)
            r.state = CANCELLED
            return True
        if r.state == RUNNING:
            self._release(r)
            r.state, r.finish_t = CANCELLED, self.clock()
            return True
        return False

    def preempt(self, r: Request) -> None:
        """Preempt a RUNNING request back to the queue front.

        A family whose slot state declares `snapshot` (rwkv6, gla, whisper)
        and has no paged pool keeps the request's state rows
        (`_slot_snapshot`; whisper's cross K/V among them), and re-admission
        restores them: the request resumes exactly where it stopped without
        recomputing a token or re-running its encoder. Everything else (paged pools
        whose blocks are surrendered, zamba2's state) is recompute
        preemption, identical to block-pressure eviction: re-admission
        re-prefills prompt + generated, from the prefix cache where it is
        on."""
        if r.state != RUNNING:
            raise ValueError(f"cannot preempt a {r.state!r} request")
        proto = self.model.seq_caches.get("slot")
        if proto is None or not proto.snapshot or self.has_paged:
            self._evict(r)
            return
        s = r.slot
        logger.info(f"engine: snapshot-preempting request {r.rid} "
                    f"({len(r.out_tokens)}/{r.max_new_tokens} tokens done)")
        r.snapshot = self._slot_snapshot(s)
        r.snap_len = int(self.lengths[s])
        self._tenant_release(r)
        # feed / fed are KEPT: a request preempted mid-prefill resumes its
        # feed from the restored state, a decoding one keeps its pending token
        r.slot = None
        r.state, r.preemptions = QUEUED, r.preemptions + 1
        self.slots[s] = None
        self.lengths[s] = 0
        self.queue.appendleft(r)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def run(self, max_steps: int = 100_000) -> List[Request]:
        """Drive `step()` until every submitted request finishes."""
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.busy:
                return done
            done.extend(self.step())
        raise RuntimeError(f"engine did not drain in {max_steps} steps")

    def assert_bounded_traces(self) -> None:
        """The bounded-shape contract: no matter how requests arrive or
        interleave, the engine runs a FIXED set of step shapes. Normal mode:
        at most two token-window widths, prefill_chunk and 1. Speculative
        mode: at most three — the two-model prefill step (width
        prefill_chunk), the k draft feeds and the width-(k+1) verify. With
        the prefix cache on, the copy-on-write block copy ("cow") besides;
        with slot state, the per-slot ops ("slot_reset", with `snapshot`
        "snapshot" and "restore", with an encoder "encode"). (The JAX package
        counts traced computations; this engine counts the shapes it has
        run.)"""
        k = self.spec_k
        if k:
            allowed = {("prefill", self.ecfg.prefill_chunk), ("draft", k),
                       ("verify", k + 1)}
        else:
            allowed = {1, self.ecfg.prefill_chunk}
        if self.ecfg.prefix_cache:
            # the copy-on-write block copy: block ids are data, one more shape
            allowed = allowed | {"cow"}
        if self.has_slot:
            # the per-slot state ops: the slot is data, one shape each
            allowed = allowed | {"slot_reset"}
            if self.model.seq_caches["slot"].snapshot:
                allowed = allowed | {"snapshot", "restore"}
        if self.model.supports(CAP_ENCODER):
            # the encoder pass at admission: one (1, enc_seq, d_model) shape
            allowed = allowed | {"encode"}
        if not set(self.traces) <= allowed:
            raise AssertionError(
                f"unexpected step shapes {set(self.traces)} (allowed {allowed})")

    def acceptance_summary(self) -> Dict[str, Any]:
        """Accepted-length accounting over every request this engine has
        seen. `accepted_len` counts tokens emitted per verify round (the
        accepted draft prefix + the target's correction or bonus token), so
        its mean is the speculative multiplier on target steps."""
        live = [x for x in self.slots if x is not None] + list(self.queue)
        entries = [a for r in self.finished + live for a in r.accept_lens]
        hist: Dict[int, int] = {}
        for a in entries:
            hist[a + 1] = hist.get(a + 1, 0) + 1
        return {
            # engine-level verify rounds vs per-slot accept entries: one
            # round serves every decoding slot, so entries >= rounds
            "spec_rounds": self.spec_rounds,
            "accept_entries": len(entries),
            "mean_accepted_len": (float(np.mean([a + 1 for a in entries]))
                                  if entries else 0.0),
            "accepted_len_hist": {str(n): c for n, c in sorted(hist.items())},
        }

    def prefix_cache_report(self) -> Dict[str, Any]:
        """Prefix-cache telemetry: the cache_stats counters plus the derived
        block-reuse rate (shared grants over all grants) and the index's
        current size."""
        out: Dict[str, Any] = dict(self.cache_stats)
        grants = out["shared_block_grants"] + out["fresh_block_grants"]
        out["block_reuse_rate"] = (
            round(out["shared_block_grants"] / grants, 4) if grants else 0.0)
        out["cached_blocks_now"] = self.alloc.num_cached
        return out

    # -- scheduler ----------------------------------------------------------

    def step(self) -> List[Request]:
        """One scheduler iteration: admit from the queue, run one model step
        over every active slot, harvest finished requests. Returns the
        requests that finished during this step.

        In speculative mode a pure-decode step becomes a draft/verify round
        (`_spec_round`). A step with a prefilling slot keeps the mixed
        shape — decoding slots advance one plain token there — and feeds
        the window through both models."""
        self._admit()
        active = [(s, r) for s, r in enumerate(self.slots) if r is not None]
        if not active:
            return []
        if self.spec_k and not any(r.prefilling for _, r in active):
            return self._spec_round(active)
        ecfg = self.ecfg
        t = ecfg.prefill_chunk if any(r.prefilling for _, r in active) else 1

        # pass 1 — reserve blocks (paged families only: slot state is
        # fixed-size, so a slot-only family never starves or evicts here).
        # Reservation may EVICT other active slots (recompute preemption), so
        # it must complete before any tokens are packed: a slot evicted here
        # simply drops out of pass 2.
        def want(r):
            return min(len(r.feed) - r.fed, t) if r.prefilling else 1
        if self.has_paged:
            for s, r in active:
                if self.slots[s] is not r:
                    continue       # evicted by an earlier reservation
                self._ensure_blocks(r, int(self.lengths[s]) + want(r))

        # pass 1.5 — copy-on-write: a slot about to write into a block the
        # prefix cache granted read-only (refcount > 1) gets a private copy
        # first. Like pass 1 this can evict, so it completes before any
        # tokens are packed (and before the block tables are uploaded).
        if ecfg.prefix_cache:
            for s, r in enumerate(self.slots):
                if r is None:
                    continue
                w = want(r)
                if len(r.blocks) * ecfg.block_size >= int(self.lengths[s]) + w:
                    self._cow_for_write(r, s, w)

        # pass 2 — pack the surviving slots into one batch (a slot whose
        # write would still touch a shared block, COW having found no block,
        # waits this step, like starvation)
        tokens = np.zeros((ecfg.num_slots, t), np.int32)
        n_new = np.zeros(ecfg.num_slots, np.int32)
        active = [(s, r) for s, r in enumerate(self.slots) if r is not None]
        for s, r in active:
            w = want(r)
            if self.has_paged and (
                    len(r.blocks) * ecfg.block_size < int(self.lengths[s]) + w):
                continue               # starved of blocks: waits this step
            if self._write_shared(r, s, w):
                continue               # COW starved: waits this step
            if r.prefilling:
                tokens[s, :w] = r.feed[r.fed:r.fed + w]
            else:
                tokens[s, 0] = r.out_tokens[-1]
            n_new[s] = w

        next_tok = self._model_step(tokens, n_new)
        key = self._shape_key(t)
        self.traces[key] = self.traces.get(key, 0) + 1
        self.steps += 1

        done: List[Request] = []
        for s, r in active:
            if self.slots[s] is not r or not n_new[s]:
                continue               # evicted by _ensure_blocks, or starved
            r.fed += int(n_new[s])
            self.lengths[s] += int(n_new[s])
            if ecfg.prefix_cache:
                self._register_blocks(s, r)
            if not r.prefilling:       # last valid token's logits are usable
                if r.first_token_t is None:
                    r.first_token_t = self.clock()
                self._emit(r, int(next_tok[s]))
                if r.done:
                    self._finish(r)
                    done.append(r)
        return done

    # -- speculative round ----------------------------------------------------

    def _spec_round(self, active) -> List[Request]:
        """One draft/verify round over every decoding slot.

        1. RESERVE: a round writes K/V up to `lengths + k` (the pending token
           and k drafts) before any rollback, so each slot's block table must
           cover lengths + k + 1 tokens first, and with the prefix cache on
           every shared block in that span is copied first (copy-on-write,
           both pools). A reservation or a copy may evict a slot that
           reserved earlier, so participation is decided only after all of
           them; a slot that cannot be covered sits the round out (n_new = 0
           masks it everywhere), and a round nobody joins emits nothing.
        2. DRAFT: k+1 width-1 feeds of the draft model, k greedy tokens.
        3. VERIFY: one width-(k+1) target step over [pending, d_1..d_k]
           gives the target's argmax after every fed token.
        4. ACCEPT AND ROLL BACK: the longest draft prefix matching those
           argmaxes is accepted and the round emits accepted + 1 tokens (the
           +1 is the target's own next token: the correction on a mismatch,
           the bonus on full acceptance), capped by the request's budget.
           `lengths` advances by exactly the emitted count, so the K/V of
           rejected drafts stays past the readable horizon and is overwritten
           by the next round; the draft pool rolls back the same way, since
           both pools share block tables and `lengths`. Only then are the
           newly completed blocks published to the prefix cache, so a
           rejected draft's K/V never enters the index."""
        ecfg, k = self.ecfg, self.spec_k
        for s, r in active:
            if self.slots[s] is not r:
                continue               # evicted by an earlier reservation
            self._ensure_blocks(r, int(self.lengths[s]) + k + 1)
        if ecfg.prefix_cache:
            for s, r in enumerate(self.slots):
                if r is not None and (len(r.blocks) * ecfg.block_size
                                      >= int(self.lengths[s]) + k + 1):
                    self._cow_for_write(r, s, k + 1)
        live = [(s, r) for s, r in enumerate(self.slots) if r is not None
                and len(r.blocks) * ecfg.block_size >= int(self.lengths[s]) + k + 1
                and not self._write_shared(r, s, k + 1)]
        if not live:
            self.steps += 1            # starved round: everyone waits
            return []

        pend = np.zeros((ecfg.num_slots, 1), np.int32)
        n_one = np.zeros(ecfg.num_slots, np.int32)
        for s, r in live:
            pend[s, 0] = r.out_tokens[-1]
            n_one[s] = 1
        out = self._model_round(pend, n_one)
        drafts, target = out[:, :k], out[:, k:]
        for key in (("draft", k), ("verify", k + 1)):
            self.traces[key] = self.traces.get(key, 0) + 1
        self.steps += 1
        self.spec_rounds += 1

        done: List[Request] = []
        for s, r in live:
            accepted = 0
            while accepted < k and target[s, accepted] == drafts[s, accepted]:
                accepted += 1
            emit = [int(t) for t in target[s, :accepted + 1]]
            emit = emit[:r.max_new_tokens - len(r.out_tokens)]
            # the REALISED advance (budget cap included), so the mean
            # accepted length is the true multiplier on target steps
            r.accept_lens.append(len(emit) - 1)
            for tok in emit:
                self._emit(r, tok)
            self.lengths[s] += len(emit)       # the rollback
            if ecfg.prefix_cache:
                self._register_blocks(s, r)
            if r.done:
                self._finish(r)
                done.append(r)
        return done

    # -- internals ----------------------------------------------------------

    def _shape_key(self, t: int):
        """How `traces` and the step graphs key a model step of width t:
        the width, or ("prefill", t) in speculative mode, where the step
        feeds both models."""
        return ("prefill", t) if self.spec_k else t

    def _model_step(self, tokens: np.ndarray, n_new: np.ndarray) -> np.ndarray:
        """Run the model over one packed batch: ONE upload (tokens, lengths,
        n_new and the block tables in a single int32 buffer), the step, ONE
        download of every slot's greedy next token. In speculative mode the
        draft ingests the same window. On the card the step is a CUDA graph."""
        if self._graphs is None:
            return self._eager_step(tokens, n_new)
        return self._graphs.step(self, tokens, n_new)

    def _model_round(self, pend: np.ndarray, n_one: np.ndarray) -> np.ndarray:
        """One draft/verify round over ONE upload in the width-1 layout (the
        pending tokens, lengths, n_one — 1 for a slot that joins the round —
        and the block tables): the k+1 draft feeds, the verify, and ONE
        download of (S, 2k+1) int32 — the k drafts, then the target's greedy
        token after each of the k+1 fed tokens. On the card two CUDA graphs,
        the verify reading the drafts where the draft graph left them."""
        if self._graphs is None:
            return self._eager_round(pend, n_one)
        return self._graphs.round(self, pend, n_one)

    def _host_upload(self, tokens: np.ndarray, n_new: np.ndarray) -> torch.Tensor:
        """The upload packed afresh and copied to the device."""
        buf = np.empty(self._upload_len(tokens.shape[1]), np.int32)
        self._pack(buf, tokens, n_new)
        return torch.from_numpy(buf).to(self.device)

    def _eager_step(self, tokens: np.ndarray, n_new: np.ndarray) -> np.ndarray:
        """`_model_step` without a graph: the upload, the eager body, the
        download."""
        nxt = self._step_body(self.caches, self._host_upload(tokens, n_new),
                              tokens.shape[1], self.draft_caches)
        if is_process_mesh(self.mesh):
            nxt = check_lockstep(nxt, self.mesh.group("world"))
        return nxt.cpu().numpy()

    def _eager_round(self, pend: np.ndarray, n_one: np.ndarray) -> np.ndarray:
        """`_model_round` without graphs."""
        buf = self._host_upload(pend, n_one)
        drafts = self._draft_body(self.draft_caches, buf)
        return self._verify_body(self.caches, buf, drafts).cpu().numpy()

    def _upload_len(self, t: int) -> int:
        s, nbw = self.block_tables.shape
        return s * t + 2 * s + s * nbw

    def _pack(self, buf: np.ndarray, tokens: np.ndarray, n_new: np.ndarray) -> None:
        """The step's upload into `buf` (int32): tokens, lengths, n_new, the
        block tables."""
        s, t = tokens.shape
        o1, o2, o3 = s * t, s * t + s, s * t + 2 * s
        buf[:o1] = tokens.reshape(-1)
        buf[o1:o2] = self.lengths
        buf[o2:o3] = n_new
        buf[o3:] = self.block_tables.reshape(-1)

    def _unpack(self, buf: torch.Tensor, t: int):
        """(tokens (S, t), lengths, n_new, block tables): views of an upload."""
        s, nbw = self.block_tables.shape
        o1, o2, o3 = s * t, s * t + s, s * t + 2 * s
        return buf[:o1].view(s, t), buf[o1:o2], buf[o2:o3], buf[o3:].view(s, nbw)

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[..., :self.model.cfg.vocab], dim=-1).to(torch.int32)

    @torch.no_grad()
    def _step_body(self, caches, buf: torch.Tensor, t: int,
                   draft_caches=None) -> torch.Tensor:
        """The model step, eagerly, over one packed upload `buf` on the
        device and the KV pools `caches` (updated in place): every slot's
        greedy next token, (S,) int32 on the device. With `draft_caches`
        (speculative mode) the draft ingests the same window into its own
        pool, so that its cache tracks the target's; its logits go unused.
        On the card this is what each width's graph captures."""
        args = self._unpack(buf, t)
        logits, _ = self.model.serving_step(self.params, caches, *args)
        if draft_caches is not None:
            self.model.serving_step(self.draft_params, draft_caches, *args)
        return self._greedy(logits)

    @torch.no_grad()
    def _draft_body(self, draft_caches, buf: torch.Tensor) -> torch.Tensor:
        """k greedy draft tokens per slot, (S, k) int32 on the device: k+1
        width-1 draft steps over one upload in the width-1 layout, each
        step's token fed to the next and the draft's lengths advanced by
        n_one on the device (the counterpart of the JAX package's scanned
        draft). The last feed pushes d_k through the draft so that its K/V
        lands at lengths + k before acceptance is known: without it a fully
        accepted round (lengths += k + 1) would leave a hole at d_k's
        position in the draft cache, which the draft would attend as stale
        data from then on. The (k+1)-th token is dropped; rejected feeds roll
        back by the lengths mask like everything else. On the card this is
        what the draft graph captures."""
        tok, lengths, n_one, tables = self._unpack(buf, 1)
        drafts = []
        for _ in range(self.spec_k + 1):
            logits, _ = self.model.serving_step(self.draft_params, draft_caches, tok,
                                                lengths, n_one, tables)
            nxt = self._greedy(logits)
            drafts.append(nxt)
            tok, lengths = nxt[:, None], lengths + n_one
        return torch.stack(drafts[:self.spec_k], dim=1)

    @torch.no_grad()
    def _verify_body(self, caches, buf: torch.Tensor, drafts: torch.Tensor) -> torch.Tensor:
        """The target's width-(k+1) verify over [pending, drafts], its tokens
        assembled on the device: (S, 2k+1) int32, the drafts and then the
        target's greedy token after each fed token. On the card this is what
        the verify graph captures, reading `drafts` from the draft graph's
        output."""
        pend, lengths, n_one, tables = self._unpack(buf, 1)
        # a slot out of the round feeds token 0 in every position, as in the
        # JAX package: its drafts are not fed. The rows of a dense model do
        # not see each other, but an MoE layer routes every row of the step
        # together, so what an idle row holds can drop another's token.
        tokens = torch.cat([pend, drafts * n_one[:, None]], dim=1)
        logits, _ = self.model.serving_verify(self.params, caches, tokens, lengths,
                                              n_one * (self.spec_k + 1), tables)
        return torch.cat([drafts, self._greedy(logits)], dim=1)

    def _admit(self) -> None:
        """Admission: pick the next queued request under the configured
        policy (`_pick_next`), then grant blocks all-or-nothing for its feed
        (with `chunked_prefill`, only through its first chunk: later chunks
        grow the table lazily through `_ensure_blocks`). With `prefix_cache`
        on, the feed's longest block-aligned prefix already in the hash index
        is shared read-only instead of re-prefilled; at least the feed's last
        token is always re-fed, because its logits seed the first generated
        token.

        A slot-state family skips the block accounting: a free slot is all
        admission needs, and the slot's state rows are zeroed
        (`_slot_reset`; an encoder-decoder request's encoder then runs into
        them, `_slot_encode`). A snapshot-preempted request restores its
        saved rows and resumes mid-stream instead of re-prefilling."""
        ecfg = self.ecfg
        for s in range(ecfg.num_slots):
            if self.slots[s] is not None or not self.queue:
                continue
            r = self._pick_next()
            if r is None:
                return                 # nothing admissible this step
            if r.snapshot is not None:
                self.queue.remove(r)
                self._slot_restore(s, r.snapshot)
                r.state, r.slot = RUNNING, s
                self.slots[s] = r
                self.lengths[s] = r.snap_len
                self.block_tables[s] = 0
                r.snapshot, r.snap_len = None, 0
                self._tenant_acquire(r)
                continue
            feed = r.resume_feed()
            shared, hashes = self._match_prefix(feed) if ecfg.prefix_cache else ([], [])
            cached_len = len(shared) * ecfg.block_size
            if shared and cached_len >= len(feed):
                cached_len = len(feed) - 1
            # protect the matched blocks from alloc()'s cache reclaim by
            # taking our reference BEFORE allocating the fresh remainder
            for b in shared:
                self.alloc.share(b)
            blocks: List[int] = []
            if self.has_paged:
                need_tokens = len(feed)
                if ecfg.chunked_prefill:
                    need_tokens = min(len(feed), cached_len + ecfg.prefill_chunk)
                blocks = self.alloc.alloc(
                    max(cdiv(need_tokens, ecfg.block_size) - len(shared), 0))
                if blocks is None:
                    self.alloc.free(shared)    # undo the shares; r stays queued
                    return         # all-or-nothing: don't starve the pick
            self.queue.remove(r)
            self.cache_stats["cached_tokens"] += cached_len
            self.cache_stats["shared_block_grants"] += len(shared)
            self.cache_stats["fresh_block_grants"] += len(blocks)
            r.cached_tokens = cached_len
            r.hash_chain = hashes
            r.feed = feed
            r.blocks = shared + blocks
            r.state, r.slot, r.fed = RUNNING, s, cached_len
            self.slots[s] = r
            self.lengths[s] = cached_len
            self.block_tables[s] = 0
            self.block_tables[s, :len(r.blocks)] = r.blocks
            if self.has_slot:
                self._slot_reset(s)
                if r.frames is not None:
                    self._slot_encode(s, r.frames)
            self._tenant_acquire(r)

    # -- per-slot state ops (SlotStateCache) ----------------------------------
    # Eager, in place, on the current stream between two replays, as the
    # copy-on-write copy is: the slot is a host int, so nothing waits for the
    # card, and every state tensor a step graph reads keeps its identity.
    # Each op is one entry in `traces`, the counterpart of the reference's
    # one jitted function per op. On a mesh a leaf's model ranks hold its
    # parts (`_state_parts`), every data rank the same tensors.

    def _state_parts(self, name: str) -> List[torch.Tensor]:
        """The tensors holding slot-state leaf `name`: itself, or on a mesh
        each distinct part, in rank order."""
        state = self.caches["slot"]
        if isinstance(state, MeshTree):
            return state.named_tensors(name)
        return [state[name]]

    @torch.no_grad()
    def _slot_reset(self, s: int) -> None:
        """Zero slot `s`'s state rows: a fresh stint must not read the
        previous occupant's recurrence."""
        for name in self.model.seq_caches["slot"].names:
            for t in self._state_parts(name):
                t[:, s].zero_()
        self.traces["slot_reset"] = self.traces.get("slot_reset", 0) + 1

    @torch.no_grad()
    def _slot_encode(self, s: int, frames: torch.Tensor) -> None:
        """Run the encoder ONCE for the request admitted into slot `s` and
        write its cross-attention K/V into the slot's rows of "ck" / "cv" in
        place (CAP_ENCODER): the encoder is a second prefill shape, fixed at
        (1, enc_seq, d_model). On a mesh each model rank's part takes its
        kv heads."""
        ck, cv = self.model.encode_prefill(self.params, frames)
        for name, value in (("ck", ck), ("cv", cv)):
            parts = self._state_parts(name)
            for t, v in zip(parts, parts_on(value, len(parts), 2)):
                t[:, s].copy_(v)
        self.traces["encode"] = self.traces.get("encode", 0) + 1

    @torch.no_grad()
    def _slot_snapshot(self, s: int) -> Dict[str, List[torch.Tensor]]:
        """Copies of slot `s`'s state rows, part by part (a preemption
        snapshot)."""
        snap = {name: [t[:, s].clone() for t in self._state_parts(name)]
                for name in self.model.seq_caches["slot"].names}
        self.traces["snapshot"] = self.traces.get("snapshot", 0) + 1
        return snap

    @torch.no_grad()
    def _slot_restore(self, s: int, snap: Dict[str, List[torch.Tensor]]) -> None:
        """Put a preemption snapshot back into slot `s`."""
        for name, saved in snap.items():
            for t, v in zip(self._state_parts(name), saved):
                t[:, s].copy_(v)
        self.traces["restore"] = self.traces.get("restore", 0) + 1

    # -- prefix cache, copy-on-write and tenant accounting --------------------

    def _chunk_hash(self, prev: int, chunk: np.ndarray) -> int:
        """Chain hash of one full token block given the chain value of
        everything before it: position-0-anchored, so equal hashes mean the
        ENTIRE prefix up to this block matches, not just the chunk."""
        return hash((prev, np.ascontiguousarray(chunk, np.int32).tobytes()))

    def _match_prefix(self, feed: np.ndarray):
        """(shared_blocks, chain_hashes): the longest prefix of `feed`'s full
        blocks present in the hash index, at block granularity."""
        bs = self.ecfg.block_size
        shared: List[int] = []
        hashes: List[int] = []
        h = self._prefix_salt
        for i in range(len(feed) // bs):
            h = self._chunk_hash(h, feed[i * bs:(i + 1) * bs])
            b = self.alloc.lookup(h)
            if b is None:
                break
            shared.append(b)
            hashes.append(h)
        return shared, hashes

    def _register_blocks(self, s: int, r: Request) -> None:
        """Publish every newly COMPLETED full block of slot `s` (its end is
        at or below the accepted `lengths`, so speculative writes past
        `lengths` never reach a registered block) to the hash index. The
        index takes its own reference, so the entry outlives the request."""
        bs = self.ecfg.block_size
        full = int(self.lengths[s]) // bs
        if full <= len(r.hash_chain):
            return
        stream = (np.concatenate([r.prompt, np.asarray(r.out_tokens, np.int32)])
                  if r.out_tokens else r.prompt)
        for i in range(len(r.hash_chain), full):
            prev = r.hash_chain[-1] if r.hash_chain else self._prefix_salt
            h = self._chunk_hash(prev, stream[i * bs:(i + 1) * bs])
            if self.alloc.register(r.blocks[i], h):
                self.cache_stats["registered_blocks"] += 1
            r.hash_chain.append(h)

    def _touched_blocks(self, r: Request, s: int, w: int):
        """Logical block indices the next `w`-token write at `lengths[s]`
        lands in (clipped to the table)."""
        bs = self.ecfg.block_size
        start = int(self.lengths[s])
        return range(start // bs, min(cdiv(start + w, bs), len(r.blocks)))

    def _write_shared(self, r: Request, s: int, w: int) -> bool:
        """True if any block the next write touches is still shared: writing
        would corrupt another reference's read-only view."""
        if not self.ecfg.prefix_cache:
            return False
        return any(self.alloc.refcount(r.blocks[i]) > 1
                   for i in self._touched_blocks(r, s, w))

    def _cow_for_write(self, r: Request, s: int, w: int) -> bool:
        """Copy-on-write: give `r` a private copy of every shared block its
        next `w`-token write touches, before the step appends to it (both
        pools in speculative mode). Under pool exhaustion the youngest other
        running request is evicted, as in `_ensure_blocks`; False means `r`
        waits this step."""
        for i in self._touched_blocks(r, s, w):
            old = r.blocks[i]
            if self.alloc.refcount(old) <= 1:
                continue               # sole owner: write in place
            got = self.alloc.alloc(1)
            while got is None:
                victim = self._youngest_running(exclude=r)
                if victim is None:
                    return False       # nothing to evict; r waits this step
                self._evict(victim)
                got = self.alloc.alloc(1)
            new = self._count_fresh(got)[0]
            self._cow_copy(old, new)
            r.blocks[i] = new
            self.block_tables[s, i] = new      # reaches the step through its upload
            self.alloc.free([old])     # drop our reference; sharers keep it
            self.cache_stats["cow_copies"] += 1
        return True

    @torch.no_grad()
    def _cow_copy(self, src: int, dst: int) -> None:
        """Block `src`'s rows of every per-block pool tensor (K, V and the
        int8 pools' scales; the per-layer smoothing vectors are not per
        block) copied into block `dst`, in the target pool and the draft's.
        In place, so the tensors the step graphs read stay the same; eager,
        on the current stream, so it runs after the last replay and before
        the next upload. Block ids are host ints: no sync, no new tensor.
        Counted as one "cow" step shape."""
        for caches in (self.caches, self.draft_caches):
            if caches is None:
                continue
            pool = caches["paged"]
            for name in ("k", "v", "k_scale", "v_scale"):
                if name not in pool:
                    continue
                held = pool.named_tensors(name) if isinstance(pool, MeshTree) else [pool[name]]
                for t in held:              # every rank's part, every copy of it
                    t[:, dst].copy_(t[:, src])
        self.traces["cow"] = self.traces.get("cow", 0) + 1

    def _pick_next(self) -> Optional[Request]:
        """The admission pick. "fcfs": the queue head. "priority": among
        requests whose tenant stays under `tenant_token_budget`, the highest
        priority wins; ties go to the tenant with the smallest weighted fair
        share (tokens served / weight), then to arrival order."""
        if not self.queue:
            return None
        if self.ecfg.scheduler == "fcfs":
            return self.queue[0]
        budget = self.ecfg.tenant_token_budget
        weights = self.ecfg.tenant_weights or {}

        def admissible(r: Request) -> bool:
            if budget is None:
                return True
            need = len(r.resume_feed()) + r.max_new_tokens - len(r.out_tokens)
            return self._tenant_inflight.get(r.tenant, 0) + need <= budget

        eligible = [r for r in self.queue if admissible(r)]
        if not eligible:
            return None
        return min(eligible, key=lambda r: (
            -r.priority,
            self._tenant_served.get(r.tenant, 0) / weights.get(r.tenant, 1.0),
            r.rid))

    def _tenant_acquire(self, r: Request) -> None:
        r.inflight_tokens = len(r.feed) + r.max_new_tokens - len(r.out_tokens)
        self._tenant_inflight[r.tenant] = (
            self._tenant_inflight.get(r.tenant, 0) + r.inflight_tokens)

    def _tenant_release(self, r: Request) -> None:
        self._tenant_inflight[r.tenant] = (
            self._tenant_inflight.get(r.tenant, 0) - r.inflight_tokens)
        r.inflight_tokens = 0

    def _emit(self, r: Request, tok: int) -> None:
        """Append one generated token: bookkeeping + streaming callback."""
        r.out_tokens.append(tok)
        self._tenant_served[r.tenant] = self._tenant_served.get(r.tenant, 0) + 1
        if r.on_token is not None:
            r.on_token(r, tok)

    def _ensure_blocks(self, r: Request, tokens_needed: int) -> bool:
        """Grow `r`'s block table to cover `tokens_needed` cached tokens.
        On pool exhaustion, evict the youngest other running request
        (recompute preemption) and retry; False if `r` still cannot be served
        this step."""
        while True:
            need = cdiv(tokens_needed, self.ecfg.block_size) - len(r.blocks)
            if need <= 0:
                return True
            got = self.alloc.alloc(need)
            if got is not None:
                self._count_fresh(got)
                self.block_tables[r.slot, len(r.blocks):len(r.blocks) + len(got)] = got
                r.blocks.extend(got)
                continue
            victim = self._youngest_running(exclude=r)
            if victim is None:
                return False           # nothing to evict; r waits this step
            self._evict(victim)

    def _count_fresh(self, got: List[int]) -> List[int]:
        self.cache_stats["fresh_block_grants"] += len(got)
        return got

    def _youngest_running(self, exclude: Request) -> Optional[Request]:
        running = [r for r in self.slots
                   if r is not None and r is not exclude]
        return max(running, key=lambda r: r.rid) if running else None

    def _release(self, r: Request) -> None:
        """Give back `r`'s slot, its blocks (refcounted: sharers and the
        hash index keep theirs) and its tenant's inflight tokens."""
        s = r.slot
        self.alloc.free(r.blocks)
        self._tenant_release(r)
        r.blocks, r.slot, r.feed = [], None, None
        self.slots[s] = None
        self.lengths[s] = 0
        self.block_tables[s] = 0

    def _evict(self, r: Request) -> None:
        """Recompute preemption: return `r` to the FRONT of the queue with its
        blocks freed; on re-admission it re-prefills prompt + generated."""
        logger.info(f"engine: preempting request {r.rid} "
                    f"({len(r.out_tokens)}/{r.max_new_tokens} tokens done)")
        self._release(r)
        r.fed, r.hash_chain = 0, []
        r.state, r.preemptions = QUEUED, r.preemptions + 1
        self.queue.appendleft(r)

    def _finish(self, r: Request) -> None:
        self._release(r)
        r.state, r.finish_t = FINISHED, self.clock()
        self.finished.append(r)


def _tensors_in(tree) -> List[torch.Tensor]:
    """Every tensor of a parameter or cache tree, a ClusteredTensor's fields
    included (a mesh's: every distinct tensor), in a fixed order."""
    if isinstance(tree, MeshTree):
        return tree.tensors()
    if is_clustered(tree):
        return [t for f in CT_ARRAY_FIELDS for t in _tensors_in(getattr(tree, f))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors_in(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


@dataclasses.dataclass(frozen=True)
class _Upload:
    """One width's upload buffers, which its graphs read: the pinned host
    buffer and its device copy."""
    host: torch.Tensor
    dev: torch.Tensor


class _StepGraphs:
    """The engine's model steps on the card as CUDA graphs, one per step
    shape: the step of each token-window width (the counterpart of the JAX
    package's `_step_fn`, jitted per width), and in speculative mode the
    two-model prefill step, the k+1 draft feeds and the width-(k+1) verify
    (the counterparts of `_spec_prefill_fn`, `_draft_fn` and `_verify_fn`).
    A shape's graph is captured at its first call, which runs eagerly on a
    side stream as the capture's warm-up and is that call's real result;
    every later call replays it.

    Every replay reads its data from the same buffers: the upload is packed
    into a pinned host buffer per width and copied into that width's device
    buffer outside the graphs, and the verify graph reads the drafts from
    the draft graph's output, so a round is one upload and one download. A
    download is the fence after which a pinned buffer may be rewritten. All
    graphs capture into one memory pool, which is safe because their
    replays never overlap and every output a later graph reads stays alive.

    A graph reads the parameters and the KV pools (the draft's too) where
    they lay when it was captured: a call after any of them was replaced
    raises."""

    def __init__(self):
        self._stream = self._pool = None          # made at the first capture
        self._uploads: Dict[int, _Upload] = {}    # per width
        self._graphs: Dict[Any, _CapturedStep] = {}
        self._read: Optional[List[torch.Tensor]] = None

    def capture_seconds(self) -> Dict[Any, float]:
        """Host seconds each shape's capture and instantiation took, keyed
        as `ServingEngine.traces`."""
        return {key: g.capture_s for key, g in self._graphs.items()}

    def check_read(self, engine: "ServingEngine") -> None:
        """Record the tensors the graphs read (the params and the KV pools,
        the draft's included) at the first call; raise at a later one if any
        was replaced."""
        read = [t for tree in (engine.params, engine.draft_params, engine.caches,
                               engine.draft_caches) for t in _tensors_in(tree)]
        if self._read is None:
            self._read = read
        elif len(read) != len(self._read) or any(
                a is not b for a, b in zip(read, self._read)):
            raise RuntimeError(
                "ServingEngine: the params or the KV pools were replaced after the "
                "step was captured as a CUDA graph, which would go on reading the "
                "old tensors; build a new engine for new weights or pools")

    def _upload(self, engine: "ServingEngine", tokens: np.ndarray,
                n_new: np.ndarray) -> torch.Tensor:
        """The width's device upload buffer, holding this call's upload."""
        t = tokens.shape[1]
        up = self._uploads.get(t)
        if up is None:
            host = torch.empty(engine._upload_len(t), dtype=torch.int32, pin_memory=True)
            up = self._uploads[t] = _Upload(host, torch.empty_like(host, device=engine.device))
        engine._pack(up.host.numpy(), tokens, n_new)
        up.dev.copy_(up.host, non_blocking=True)
        return up.dev

    def _run(self, engine: "ServingEngine", key, body) -> torch.Tensor:
        """`body`'s result for this call: the replay's output buffer, or at
        the key's first call the warm-up's result (and the capture)."""
        captured = self._graphs.get(key)
        if captured is not None:
            captured.replay()
            return captured.out
        if self._stream is None:
            self._stream = torch.cuda.Stream(engine.device)
            self._pool = torch.cuda.graph_pool_handle()
        first, self._graphs[key] = _warm_up_and_capture(body, self._stream, self._pool)
        return first

    def step(self, engine: "ServingEngine", tokens: np.ndarray,
             n_new: np.ndarray) -> np.ndarray:
        self.check_read(engine)
        t = tokens.shape[1]
        dev = self._upload(engine, tokens, n_new)
        nxt = self._run(engine, engine._shape_key(t), lambda: engine._step_body(
            engine.caches, dev, t, engine.draft_caches))
        return nxt.cpu().numpy()

    def round(self, engine: "ServingEngine", pend: np.ndarray,
              n_one: np.ndarray) -> np.ndarray:
        self.check_read(engine)
        k = engine.spec_k
        dev = self._upload(engine, pend, n_one)
        drafts = self._run(engine, ("draft", k),
                           lambda: engine._draft_body(engine.draft_caches, dev))
        held = self._graphs[("draft", k)].out     # where the verify graph reads them
        if drafts is not held:                    # the draft graph's warm-up round
            held.copy_(drafts)
        out = self._run(engine, ("verify", k + 1),
                        lambda: engine._verify_body(engine.caches, dev, held))
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# int8 KV cache: smoothing calibration + capacity accounting
# ---------------------------------------------------------------------------

def calibrate_kv_smooth(model: Model, params, *, n_tokens: int = 64,
                        batch: int = 4, seed: int = 0):
    """Per-(layer, kv-head, channel) smoothing vectors for the int8 paged KV
    cache, picked from the paper's Eq. 9 candidate family
    (core/smoothing.py candidate_vectors: identity, scalar strengths,
    SmoothQuant-style alpha vectors). Candidates are scored under the
    DEPLOYMENT quantizer — per-(token, kv-head) absmax int8, `models/layers.py
    quantize_kv` — so the winner is the winner at serving time (identity is
    in the family, so calibration never hurts).

    A prefill of random tokens through the static path, on the device the
    params live on, captures every layer's K and V (the (L, B, S, KV, D)
    cache is the capture). Returns (k_smooth, v_smooth), both (L, KV, D)
    float32 numpy — pass as `ServingEngine(..., kv_smooth=...)`."""
    from repro_torch.core.smoothing import candidate_vectors
    cfg = model.cfg
    dev = params["embed"].device
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, n_tokens)).astype(np.int32)).to(dev)
    cache = model.init_cache(batch, n_tokens, device=dev)
    _, cache = model.decode(params, cache, {"tokens": tokens, "pos": 0})

    def roundtrip_mse(x: np.ndarray, s: np.ndarray) -> float:
        xs = x / s                                     # (n_tokens, D)
        scale = np.maximum(np.abs(xs).max(axis=1, keepdims=True), 1e-6) / 127.0
        q = np.clip(np.round(xs / scale), -127, 127)
        return float(np.mean((q * scale * s - x) ** 2))

    def smooth_of(key: str) -> np.ndarray:
        kv = cache[key].to(torch.float32)              # (L, B, S, KV, D)
        if cache[key].dtype == torch.int8:             # int8 static cache
            kv = kv * cache[key + "_scale"][..., None]
        kv = kv.cpu().numpy()
        n_l, _, _, n_kv, d = kv.shape
        out = np.ones((n_l, n_kv, d), np.float32)
        for li in range(n_l):
            for h in range(n_kv):
                x = kv[li, :, :, h].reshape(-1, d)
                cands = candidate_vectors(np.abs(x).max(axis=0))
                out[li, h] = min(
                    (s for _, s in cands), key=lambda s: roundtrip_mse(x, s))
        return out

    return smooth_of("k"), smooth_of("v")


def paged_kv_bytes_per_block(cfg, block_size: int, kv_dtype: str) -> int:
    """Device bytes ONE physical block costs across all layers: the k + v
    pools, plus the two scale pools for int8. The (L, KV, D) smoothing
    vectors are per engine, not per block, and are excluded."""
    elems = cfg.n_layers * block_size * cfg.n_kv_heads * cfg.hd
    if kv_dtype == "int8":
        scales = cfg.n_layers * block_size * cfg.n_kv_heads * 4
        return 2 * (elems + scales)
    return 2 * elems * cfg.torch_dtype.itemsize


def kv_capacity_report(cfg, ecfg: EngineConfig,
                       tokens_per_request: int) -> Dict[str, Any]:
    """The admission arithmetic of the kv-dtype choice: at a FIXED pool byte
    budget (what this geometry's float pool costs), how many blocks each kv
    dtype buys and how many requests of `tokens_per_request` tokens are
    admissible concurrently."""
    budget = ecfg.num_blocks * paged_kv_bytes_per_block(
        cfg, ecfg.block_size, "float")
    bpr = -(-tokens_per_request // ecfg.block_size)
    out: Dict[str, Any] = {"pool_bytes_budget": budget,
                           "tokens_per_request": tokens_per_request}
    for dt in ("float", "int8"):
        bb = paged_kv_bytes_per_block(cfg, ecfg.block_size, dt)
        blocks = budget // bb
        out[dt] = {"bytes_per_block": bb, "blocks_in_budget": int(blocks),
                   "blocks_per_request": bpr,
                   "max_admissible_slots": int(blocks // bpr)}
    out["slots_ratio_int8_vs_float"] = round(
        out["int8"]["max_admissible_slots"]
        / max(out["float"]["max_admissible_slots"], 1), 2)
    return out


# ---------------------------------------------------------------------------
# Convenience constructor shared by the CLI, the smoke script and the tests
# ---------------------------------------------------------------------------

def _has_clustered(tree) -> bool:
    if is_clustered(tree):
        return True
    if isinstance(tree, dict):
        return any(_has_clustered(v) for v in tree.values())
    return False


def _tree_bytes(tree) -> int:
    """Bytes of every tensor in a parameter tree (a ClusteredTensor's fields
    included; on a mesh, of every distinct tensor it holds)."""
    if isinstance(tree, MeshTree):
        return sum(t.numel() * t.element_size() for t in tree.tensors())
    if is_clustered(tree):
        return sum(_tree_bytes(getattr(tree, f)) for f in CT_ARRAY_FIELDS)
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _process_world() -> int:
    """The size of the initialised torch.distributed process group (1 where
    none is)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def build_engine(arch: str, *, use_reduced: bool = True, lcd: bool = False,
                 target_centroids: int = 8, ecfg: Optional[EngineConfig] = None,
                 seed: int = 0, params=None, draft_params=None, kv_smooth=None,
                 fused_projections: bool = True, n_layers: Optional[int] = None,
                 device="cuda", mesh=None, devices=None):
    """(engine, params): model + params wrapped in a ready ServingEngine on
    `device` ("cuda" unless the caller asks for the CPU; asking for a card
    that is not there raises).

    Mesh selection, as the reference's: `mesh=` serves on that mesh;
    otherwise `ecfg.data_parallel` / `ecfg.model_parallel` pin a (data,
    model) mesh over the visible devices (`devices`, default every CUDA
    card for "cuda", the one CPU for "cpu"; the missing factor is derived, a
    non-factoring request raises). With neither, a `devices` list the caller
    passes gets the roofline layout search (`distributed/layout.py
    choose_layout`, its report on the engine as `layout_report`); otherwise
    the engine serves on `device` alone, however many cards are visible. A
    one-process mesh is served only where its devices repeat (`[cuda:0] x
    n`, built on request). Under an initialised torch.distributed process
    group of several processes (torchrun) the knobs must factor its size,
    or the layout search runs over its processes, and the engine serves on
    a process mesh (`launch/mesh.py init_process_mesh`, the group's
    backend; `device` is this process's), each process holding its own
    shards; a process whose weights or kv smoothing vectors differ from
    rank 0's raises (`collectives.check_same_tree`).

    Without `params`, dense weights are drawn from `seed`. With `lcd=True` and
    no clustered leaf among the params, the dense weights are LCD-compressed
    (`compress_model`; `ecfg.weight_bits` / `ecfg.bits_budget` set the packing
    policy) and the report lands on the engine as `compress_report` (None
    when nothing was compressed). Clustered params without a compression run
    come from `core/clustered_params.py materialize_clustered`. With
    `ecfg.speculative_k > 0` and no `draft_params`, the 2-bit self-draft is
    built here by re-clustering the target's weights on their device
    (`make_draft_params`, at `ecfg.draft_centroids`; its report lands on the
    engine as `draft_report`). With `ecfg.kv_dtype == "int8"` and no
    `kv_smooth`, the cache smoothing vectors are calibrated here
    (`calibrate_kv_smooth`). `n_layers` cuts the model's depth, an
    encoder-decoder's both stacks (widths stay)."""
    dev = resolve_device(device) if mesh is None else mesh.lead_device
    ecfg = EngineConfig() if ecfg is None else ecfg
    if ecfg.arch is None:
        # bind the config to the arch so capability-dependent knobs fail
        # eagerly with the capability named
        ecfg = dataclasses.replace(ecfg, arch=arch)
    model, params, report = _model_and_params(
        arch, use_reduced=use_reduced, n_layers=n_layers,
        fused_projections=fused_projections, lcd=lcd,
        target_centroids=target_centroids, weight_bits=ecfg.weight_bits,
        bits_budget=ecfg.bits_budget, seed=seed, params=params, dev=dev)
    draft_report = None
    if ecfg.speculative_k and draft_params is None:
        draft_params, draft_report = make_draft_params(
            params, draft_centroids=ecfg.draft_centroids)
        logger.info("LCD draft: " + draft_report.summary())
    resolved_kv = ecfg.kv_dtype or (
        "int8" if model.cfg.kv_cache_dtype == "int8" else "float")
    if (resolved_kv == "int8" and kv_smooth is None
            and model.supports(CAP_INT8_KV)):
        kv_smooth = calibrate_kv_smooth(model, params, seed=seed)
        logger.info("int8 KV cache: smoothing calibrated "
                    "(Eq. 9 candidate search per layer x kv-head)")
    layout_report = None
    if mesh is None:
        world = _process_world()
        # under an initialised process group (torchrun) the mesh spans its
        # processes, one device each (the layout search reads their count)
        devs = [dev] * world if world > 1 else list(devices) if devices is not None else (
            visible_devices() if dev.type == "cuda" else [dev])
        n = len(devs)
        over = f"{n} processes of the process group" if world > 1 else f"{n} visible device(s)"
        dp, mp = ecfg.data_parallel, ecfg.model_parallel
        shape = None
        if dp is not None or mp is not None:
            # derive the unpinned factor from the device (process) count
            if dp is None:
                dp = n // mp if mp and n % mp == 0 else 0
            if mp is None:
                mp = n // dp if dp and n % dp == 0 else 0
            if dp < 1 or mp < 1 or dp * mp != n:
                raise ValueError(
                    f"build_engine: data_parallel x model_parallel must "
                    f"factor the {over}; got "
                    f"{ecfg.data_parallel} x {ecfg.model_parallel}")
            shape = (dp, mp)
        elif (devices is not None or world > 1) and n > 1:
            from repro_torch.distributed.layout import choose_layout
            chosen, layout_report = choose_layout(model, params, ecfg, devices=devs)
            shape = tuple(chosen.devices.shape)
            logger.info(f"mesh layout: chose {layout_report['chosen']} over the {over}")
        if shape is not None and world > 1:
            import torch.distributed as dist
            mesh = init_process_mesh(shape, backend=dist.get_backend(), device=dev)
            # every process drew (and compressed) the weights itself
            check_same_tree((params, kv_smooth), mesh.group("world"),
                            "weights and kv smoothing vectors")
        elif shape is not None:
            mesh = make_mesh(shape, ("data", "model"), devs)
    engine = ServingEngine(model, params, ecfg, mesh=mesh, draft_params=draft_params,
                           kv_smooth=kv_smooth, device=dev)
    engine.compress_report = report
    engine.draft_report = draft_report
    engine.layout_report = layout_report
    return engine, params
