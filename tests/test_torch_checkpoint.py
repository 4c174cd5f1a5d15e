"""The port's CheckpointManager: the reference's fault-tolerance contract
(round trip, an uncommitted directory ignored, retention, shape mismatch,
auto-resume), and the format both ways — a checkpoint the reference writes
restores in the port, and one the port writes restores in the reference,
bit-equal, with bfloat16, float32, int32 and uint8 leaves, an AdamState and
a ClusteredTensor in the tree. Tolerance: exact (bytes and dtypes)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core.api import ClusteredTensor as RefCT
from repro.optim.optimizer import AdamState as RefAdam
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.api import ClusteredTensor
from repro_torch.optim.optimizer import AdamState
from repro_torch.tree import flatten_with_paths

pytestmark = pytest.mark.tier1


def tree(scale=1.0):
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4) * scale,
            "b": {"c": torch.ones(5, dtype=torch.bfloat16) * scale}}


def test_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    t = tree()
    cm.save(7, t)
    step, restored = cm.restore_latest(t)
    assert step == 7
    assert torch.equal(restored["a"], t["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], t["b"]["c"])


def test_uncommitted_checkpoint_ignored(tmp_path):
    """Crash mid-write: the directory exists but has no COMMITTED marker."""
    cm = CheckpointManager(str(tmp_path))
    t = tree()
    cm.save(1, t)
    p = cm.save(2, t)
    os.remove(os.path.join(p, "COMMITTED"))
    assert cm.latest_step() == 1
    assert cm.restore_latest(t)[0] == 1
    with pytest.raises(FileNotFoundError):
        cm.restore(2, t)
    os.makedirs(os.path.join(str(tmp_path), "step_00000005.tmp"))
    assert cm.all_steps() == [1]


def test_rolling_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree())
    assert cm.all_steps() == [3, 4]


def test_shape_mismatch_rejected(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        cm.restore(1, {"w": torch.zeros(5)})


def test_auto_resume_picks_newest_and_restores_on_the_callers_device(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    assert cm.restore_latest(tree()) == (None, None)
    cm.save(1, tree(1.0))
    cm.save(9, tree(9.0))
    step, restored = cm.restore_latest(tree(), device="cpu")
    assert step == 9 and float(restored["a"][1, 1]) == 5 * 9.0
    assert restored["a"].device.type == "cpu"


# ---------------------------------------------------------------------------
# the format, both ways
# ---------------------------------------------------------------------------

def _numpy_state(seed):
    """One state as numpy arrays: bf16 (carried as f32 values that bf16
    holds exactly), f32, int32 and uint8 leaves, Adam moments, and a
    ClusteredTensor with an unset field."""
    rng = np.random.default_rng(seed)
    bf = rng.normal(size=(4, 6)).astype(np.float32)
    bf = np.asarray(jnp.asarray(bf, jnp.bfloat16).astype(jnp.float32))
    return {
        "embed": bf,
        "w": rng.normal(size=(6, 3)).astype(np.float32),
        "ids": rng.integers(-5, 5, (3,)).astype(np.int32),
        "bytes": rng.integers(0, 255, (2, 5)).astype(np.uint8),
        "ct": dict(codes=rng.integers(0, 16, (8, 4)).astype(np.int8),
                   codebook=rng.normal(size=16).astype(np.float32),
                   smooth=rng.uniform(0.5, 1.5, 8).astype(np.float32),
                   packed=rng.integers(0, 255, (4, 4)).astype(np.uint8),
                   inv_scale=rng.uniform(0.5, 1.5, 8).astype(np.float32)),
        "step": np.int32(3),
        "m": rng.normal(size=(6, 3)).astype(np.float32),
        "v": rng.uniform(size=(6, 3)).astype(np.float32),
    }


def _ref_tree(s):
    ct = RefCT(**{k: jnp.asarray(v) for k, v in s["ct"].items()}, act_scale=None, nbits=4)
    params = {"embed": jnp.asarray(s["embed"], jnp.bfloat16), "w": jnp.asarray(s["w"]),
              "ids": jnp.asarray(s["ids"]), "bytes": jnp.asarray(s["bytes"]), "ct": ct}
    opt = RefAdam(jnp.asarray(s["step"]), {"w": jnp.asarray(s["m"])},
                  {"w": jnp.asarray(s["v"])})
    return {"params": params, "opt": opt}


def _port_tree(s):
    ct = ClusteredTensor(**{k: torch.from_numpy(v.copy()) for k, v in s["ct"].items()},
                         act_scale=None, nbits=4)
    params = {"embed": torch.from_numpy(s["embed"].copy()).to(torch.bfloat16),
              "w": torch.from_numpy(s["w"]), "ids": torch.from_numpy(s["ids"]),
              "bytes": torch.from_numpy(s["bytes"]), "ct": ct}
    opt = AdamState(torch.tensor(s["step"]), {"w": torch.from_numpy(s["m"])},
                    {"w": torch.from_numpy(s["v"])})
    return {"params": params, "opt": opt}


def _bits(x) -> tuple:
    """(dtype name, shape, raw bytes) of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        return str(t.dtype).replace("torch.", ""), tuple(t.shape), raw
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def _same_bits(port_tree, ref_tree):
    p = flatten_with_paths(port_tree)
    r = [(jax.tree_util.keystr(kp), leaf)
         for kp, leaf in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    assert [k for k, _ in p] == [k for k, _ in r]
    for (path, a), (_, b) in zip(p, r):
        assert _bits(a) == _bits(b), path


def test_paths_and_order_are_the_references():
    s = _numpy_state(0)
    _same_bits(_port_tree(s), _ref_tree(s))
    paths = [p for p, _ in flatten_with_paths(_port_tree(s))]
    assert paths[:3] == ["['opt'].step", "['opt'].m['w']", "['opt'].v['w']"]
    assert "['params']['ct'].codes" in paths and "['params']['ct'].nbits" not in paths


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    s = _numpy_state(1)
    RefManager(str(tmp_path)).save(5, _ref_tree(s), extra={"note": "ref"})
    step, got = CheckpointManager(str(tmp_path)).restore_latest(_port_tree(_numpy_state(2)))
    assert step == 5
    assert isinstance(got["opt"], AdamState) and isinstance(got["params"]["ct"], ClusteredTensor)
    assert got["params"]["ct"].nbits == 4 and got["params"]["ct"].act_scale is None
    _same_bits(got, _ref_tree(s))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    s = _numpy_state(3)
    CheckpointManager(str(tmp_path)).save(6, _port_tree(s), extra={"note": "port"})
    step, got = RefManager(str(tmp_path)).restore_latest(_ref_tree(_numpy_state(4)))
    assert step == 6
    _same_bits(_port_tree(s), got)
    # the manifests agree field for field with one the reference writes
    RefManager(str(tmp_path / "r")).save(6, _ref_tree(s), extra={"note": "port"})
    mine = json.load(open(tmp_path / "step_00000006" / "manifest.json"))
    theirs = json.load(open(tmp_path / "r" / "step_00000006" / "manifest.json"))
    assert mine == theirs
    assert {e["dtype"] for e in mine["leaves"]} >= {"bfloat16", "float32", "int32", "uint8",
                                                    "int8"}
