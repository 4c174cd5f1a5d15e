"""The port's synthetic token stream and calibration batches against the
reference's: for the same `DataConfig`, every batch byte-equal (tokens,
targets, loss mask: dtype, shape and bytes)."""
import dataclasses

import numpy as np
import pytest

from repro.data import pipeline as ref
from repro_torch.data import pipeline as port

pytestmark = pytest.mark.tier1

CONFIGS = [
    dict(vocab=512, seq_len=64, batch_size=8, seed=0),
    dict(vocab=32000, seq_len=128, batch_size=2, seed=4242, motif_prob=0.3),
    dict(vocab=256, seq_len=33, batch_size=3, seed=7, zipf_a=1.5, motif_len=4,
         host_index=1, host_count=2),
]


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b) == ["loss_mask", "targets", "tokens"]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: f"v{kw['vocab']}-s{kw['seq_len']}")
def test_synthetic_batches_are_byte_equal(kw):
    r, p = ref.SyntheticLM(ref.DataConfig(**kw)), port.SyntheticLM(port.DataConfig(**kw))
    assert dataclasses.asdict(p.cfg) == dataclasses.asdict(r.cfg)
    for step in (0, 1, 17):
        _same(p.batch(step), r.batch(step))
    for (_, a), b in zip(zip(range(2), iter(p)), [r.batch(0), r.batch(1)]):
        _same(a, b)
    b0 = p.batch(0)
    np.testing.assert_array_equal(b0["tokens"][:, 1:], b0["targets"][:, :-1])


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: f"v{kw['vocab']}-s{kw['seq_len']}")
def test_calibration_batches_are_byte_equal(kw):
    got = port.calibration_batches(port.DataConfig(**kw), n=3)
    want = ref.calibration_batches(ref.DataConfig(**kw), n=3)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _same(a, b)
    # a held-out stream: not the training stream's batches
    assert got[0]["tokens"].tobytes() != port.SyntheticLM(port.DataConfig(**kw)).batch(0)[
        "tokens"].tobytes()
