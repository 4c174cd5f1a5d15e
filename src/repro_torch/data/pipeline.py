"""Deterministic synthetic token pipeline + calibration batches — this
package's own copy of the JAX package's `data/pipeline.py`, numpy on the
host: for the same `DataConfig` the batches are byte-equal to the
reference's. Callers move them to a device.

No external datasets are needed: the pipeline synthesizes Zipfian token
streams with local n-gram structure (repeated motifs) — enough signal for
the trainer to show real loss descent, and fully deterministic (seeded) so
tests and shards agree. Shard-aware iteration (host h of H reads disjoint
strides), packed fixed-length sequences, and a separate calibration split
for the LCD smoothing / Hessian passes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_size: int              # per-host batch
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.65     # P(copy an earlier motif) — learnable structure
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Infinite deterministic stream of (tokens, targets, loss_mask) batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf over the real vocab (never emits padded ids)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def _sequence(self, rng: np.random.Generator) -> np.ndarray:
        c = self.cfg
        toks = rng.choice(c.vocab, size=c.seq_len + 1, p=self._p).astype(np.int64)
        # inject motif recurrence: spans copied from earlier in the sequence
        i = c.motif_len * 2
        while i < c.seq_len - c.motif_len:
            if rng.random() < c.motif_prob:
                src = rng.integers(0, i - c.motif_len)
                toks[i:i + c.motif_len] = toks[src:src + c.motif_len]
                i += c.motif_len
            else:
                i += 1
        return toks

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + step * c.host_count + c.host_index) & 0x7FFFFFFF)
        seqs = np.stack([self._sequence(rng) for _ in range(c.batch_size)])
        return {
            "tokens": seqs[:, :-1].astype(np.int32),
            "targets": seqs[:, 1:].astype(np.int32),
            "loss_mask": np.ones((c.batch_size, c.seq_len), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def calibration_batches(cfg: DataConfig, n: int = 8) -> list:
    """Held-out split for LCD calibration (distinct seed stream)."""
    calib = SyntheticLM(dataclasses.replace(cfg, seed=cfg.seed + 7919))
    return [calib.batch(i) for i in range(n)]
