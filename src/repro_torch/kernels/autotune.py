"""Measured tile tuner for the attention kernels, keyed on the CUDA card.

The counterpart of the JAX package's `kernels/autotune.py`, attention half:
`flash_attention` takes a (bq, bk) tile and `paged_dequant_attention` an
`l_pad` staging length. A wrapper called with its tile left as None asks
this module, which resolves in the reference's order:

  1. a cache hit returns the stored winner and never measures;
  2. on a miss with a measure function, every candidate is timed and the
     fastest is stored;
  3. otherwise — a CPU tensor (the counterpart of the reference's interpret
     mode), $REPRO_AUTOTUNE=0, or no measure function — exactly the
     heuristic.

  key        (variant, backend, geometry, nbits) as the reference spells it;
             the backend field names the card by compute capability and
             device name (`cuda-sm90-NVIDIA_H100_80GB_HBM3`), so a winner
             measured on one card is never served on another. "cpu" on the
             CPU.
  candidates the reference's grids; the heuristic is always first.
  measure    warmup, then the p50 of the repeats on the host's clock, with
             `torch.cuda.synchronize()` before and after every call.
  cache      an in-process dict backed by a versioned JSON file,
             `~/.cache/repro_torch/autotune.json` — the port's own, so the
             two packages never overwrite each other's schema;
             $REPRO_TORCH_AUTOTUNE_CACHE names another file, and
             `reset_cache(path)` another for this process. A missing,
             corrupt or wrong-version file reads as empty.

A candidate loses only by a ValueError that its wrapper raises before it
launches anything (a tile the card cannot run). Any other exception — a
failed build, a CUDA launch error — propagates: a broken kernel must not be
replaced quietly by whichever candidate happened to launch.

The LUT half of the reference's tuner (`heuristic_blocks`, `vmem_bytes`,
`candidate_blocks`, `pick_blocks`) is not here: the port's LUT kernels take
no tile shape.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

CACHE_SCHEMA_VERSION = 2   # 2: B9 bf16 on the tensor cores (a winner of the old kernel is stale)
_ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"
_ENV_ENABLE = "REPRO_AUTOTUNE"


# ---------------------------------------------------------------------------
# Heuristics and candidate grids (the reference's, unchanged)
# ---------------------------------------------------------------------------

def flash_heuristic(sq: int, sk: int) -> Tuple[int, int]:
    """The flash kernel's historical defaults, clamped to the problem."""
    return min(256, sq), min(512, sk)


def flash_candidates(sq: int, sk: int) -> List[Tuple[int, int]]:
    """(bq, bk) pairs that divide the (sq, sk) geometry exactly — the flash
    kernel requires whole blocks (no padding path). The heuristic is first."""
    heur = flash_heuristic(sq, sk)
    bqs = [b for b in (64, 128, 256, 512) if b <= sq and sq % b == 0]
    bks = [b for b in (128, 256, 512, 1024) if b <= sk and sk % b == 0]
    out = [heur]
    for bq in bqs or [sq]:
        for bk in bks or [sk]:
            if (bq, bk) != heur and (bq, bk) not in out:
                out.append((bq, bk))
    return out


def paged_heuristic() -> Tuple[int]:
    """Staging length of the gathered KV view (the reference's lane multiple)."""
    return (128,)


def paged_candidates(l: int) -> List[Tuple[int]]:
    """KV staging lengths; a second one only when L exceeds the first. Each
    is a whole number of the block body's 32-key chunks, as the card requires
    (paged_attention.py pool_plan)."""
    out = [paged_heuristic()]
    if l > 128:
        out.append((256,))
    return out


def normalize_key(m: int, k: int, n: int, nbits: int, variant: str,
                  backend: str) -> str:
    """Canonical cache key, spelled as the reference spells it. Attention
    geometry is exact (tile validity depends on exact divisibility)."""
    return f"{variant}|{backend}|m{m},k{k},n{n}|b{nbits}"


def backend_name(device) -> str:
    """The key's backend field: the card's compute capability and name, or
    "cpu"."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return dev.type
    major, minor = torch.cuda.get_device_capability(dev)
    name = torch.cuda.get_device_name(dev).replace(" ", "_")
    return f"cuda-sm{major}{minor}-{name}"


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------

def cache_path() -> str:
    return os.environ.get(
        _ENV_CACHE,
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json"))


class AutotuneCache:
    """In-process {key: entry} map backed by a JSON file.

    entry = {"blocks": [ints], "us": float, "source": "measured"}; the file
    is {"version": CACHE_SCHEMA_VERSION, "entries": {...}}, written sorted
    and atomically. A missing, empty, corrupt or wrong-version file reads as
    an empty cache (the tuner measures again rather than failing).

    In this process only: `measured` counts the candidate measurements per
    variant made on a miss of this cache (a hit makes none), and `log` keeps
    what each miss measured, {key: {"us": {tile: µs}, "refused": {tile: why}}}."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or cache_path()
        self.entries: Dict[str, dict] = {}
        self.measured: Dict[str, int] = {"flash": 0, "paged": 0}
        self.log: Dict[str, dict] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if (isinstance(doc, dict)
                    and doc.get("version") == CACHE_SCHEMA_VERSION
                    and isinstance(doc.get("entries"), dict)):
                self.entries = {
                    k: v for k, v in doc["entries"].items()
                    if isinstance(v, dict) and isinstance(v.get("blocks"), list)
                    and all(isinstance(b, int) for b in v["blocks"])}
        except (OSError, ValueError):
            pass                      # absent / corrupt file -> empty cache

    def save(self) -> None:
        doc = {"version": CACHE_SCHEMA_VERSION, "entries": self.entries}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass                      # read-only file system: in-process only

    def get(self, key: str) -> Optional[Tuple[int, ...]]:
        ent = self.entries.get(key)
        return tuple(ent["blocks"]) if ent else None

    def put(self, key: str, blocks: Sequence[int], us: float) -> None:
        self.entries[key] = {"blocks": [int(b) for b in blocks],
                             "us": round(float(us), 3), "source": "measured"}
        self.save()


_CACHE: Optional[AutotuneCache] = None


def get_cache() -> AutotuneCache:
    global _CACHE
    if _CACHE is None:
        _CACHE = AutotuneCache()
    return _CACHE


def reset_cache(path: Optional[str] = None) -> AutotuneCache:
    """Drop the in-process cache and read `path` (default: `cache_path()`)."""
    global _CACHE
    _CACHE = AutotuneCache(path)
    return _CACHE


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def tuning_enabled() -> bool:
    return os.environ.get(_ENV_ENABLE, "1") != "0"


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def measure_candidate(fn: Callable[[], object], warmup: int = 1,
                      repeats: int = 5) -> float:
    """p50 seconds of `fn()` on the host's clock after `warmup` discarded
    calls, the card synchronised before and after each call. Refuses to run
    inside CUDA-graph capture, where synchronising is an error."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune: a tile left as None missed the cache inside "
                           "CUDA-graph capture; pass the tile or tune before capturing")
    for _ in range(max(warmup, 0)):
        fn()
    _sync()
    ts = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        _sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _tune(key: str, variant: str, candidates, measure, cache: AutotuneCache):
    """Time every candidate; store and return the fastest (None if every one
    was refused)."""
    us, refused = {}, {}
    for cand in candidates:
        cache.measured[variant] += 1
        try:
            us[tuple(cand)] = measure(*cand) * 1e6
        except ValueError as e:       # refused by the wrapper before launch
            refused[tuple(cand)] = str(e)
    cache.log[key] = {"us": us, "refused": refused}
    if not us:
        return None
    best = min(us, key=us.get)
    cache.put(key, best, us[best])
    return best


def _pick(key: str, variant: str, candidates, heuristic, device, measure, cache):
    cache = cache or get_cache()
    hit = cache.get(key)
    if hit is not None:
        return hit                    # cache hit: never re-measure
    on_card = device is not None and torch.device(device).type == "cuda"
    if not on_card or measure is None or not tuning_enabled():
        return heuristic
    won = _tune(key, variant, candidates, measure, cache)
    return won if won is not None else heuristic


def pick_flash_blocks(sq: int, sk: int, d: int, *, device=None,
                      measure: Optional[Callable[..., float]] = None,
                      cache: Optional[AutotuneCache] = None) -> Tuple[int, int]:
    """(bq, bk) for `flash_attention` on `device` (None: the CPU). Key
    geometry (m=sq, k=sk, n=d), nbits=0."""
    key = normalize_key(sq, sk, d, 0, "flash", backend_name(device))
    return tuple(_pick(key, "flash", flash_candidates(sq, sk), flash_heuristic(sq, sk),
                       device, measure, cache))


def pick_paged_pad(gt: int, l: int, d: int, *, device=None,
                   measure: Optional[Callable[..., float]] = None,
                   cache: Optional[AutotuneCache] = None) -> int:
    """`l_pad` for `paged_dequant_attention` on `device` (None: the CPU).
    Key geometry (m=gt, k=l, n=d), nbits=8."""
    key = normalize_key(gt, l, d, 8, "paged", backend_name(device))
    return _pick(key, "paged", paged_candidates(l), paged_heuristic(), device, measure,
                 cache)[0]
