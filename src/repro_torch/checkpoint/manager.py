"""Checkpointing with atomic commits and auto-resume, in the JAX package's
format — the port of its `checkpoint/manager.py`. A checkpoint either
package writes, the other restores, bit for bit.

Layout:  <dir>/step_<n>/
            shard_0.npz          — the leaves, `leaf_<i>` in flattening order
            manifest.json        — per leaf: path, key, shape, logical dtype;
                                   the step and `extra`
            COMMITTED            — empty marker written LAST (atomic commit)

Leaf paths are spelled and ordered as `jax.tree_util.keystr` /
`tree_flatten_with_path` give them (`repro_torch/tree.py`): dict keys
sorted, NamedTuple fields as `.m`, `.codes`. npz holds no bfloat16, so a
bfloat16 leaf is stored as its uint16 view with the logical dtype
"bfloat16" in the manifest, as the reference stores it; here it is viewed
back with torch, with no numpy extension dtype.

Fault-tolerance contract:
  * a checkpoint without COMMITTED is ignored (crash mid-write);
  * `latest_step` is the newest committed step;
  * `restore` re-shards on load: with `shardings` the whole leaves are
    placed on the new mesh (`distributed/placement.py place(fsdp=True)`),
    which may differ from the mesh at save time (an elastic restart
    re-shards through host memory, as the reference's docstring says);
  * rolling retention keeps the newest `keep` checkpoints.

`save` takes a tree placed on a training mesh (`MeshTree`s anywhere in it)
and writes each leaf whole (`MeshTree.whole`), so the file is the one the
reference writes for the same state. One process writes the whole tree,
so there is one shard, `shard_0.npz` (the name the reference gives host
0's): a checkpoint per host waits for the multi-process backend (ROADMAP
A7).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.placement import MeshTree, place
from repro_torch.tree import flatten_with_paths, leaves, unflatten
from repro_torch.utils import logger

_SHARD = "shard_0.npz"


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name) of one leaf."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:          # numpy has no bfloat16
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _whole(tree: Any) -> Any:
    """`tree` with every placed subtree (`MeshTree`) gathered whole."""
    if isinstance(tree, MeshTree):
        return tree.whole()
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_whole(getattr(tree, f)) for f in tree._fields))
    return tree


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    arr = np.array(arr, order="C")       # keeps a 0-d leaf 0-d
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(logical), copy=False))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, extra: Optional[Dict] = None) -> str:
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {}
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for i, (name, leaf) in enumerate(flatten_with_paths(_whole(tree))):
            arr, logical = _to_numpy(torch.as_tensor(leaf))
            key = f"leaf_{i}"
            arrays[key] = arr
            manifest["leaves"].append(
                {"path": name, "key": key, "shape": list(arr.shape),
                 "dtype": logical})
        np.savez(os.path.join(tmp, _SHARD), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # atomic commit: rename then marker
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        with open(os.path.join(path, "COMMITTED"), "w"):
            pass
        self._gc()
        logger.info(f"checkpoint saved: step {step} -> {path}")
        return path

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *, shardings: Any = None, device=None) -> Any:
        """Load into the structure of `like` (a tree of tensors, real or on
        "meta"): each leaf in its stored dtype. With `shardings` (a tree of
        NamedShardings matching `like`, e.g. {"params": ps, "opt": opt_sh}
        of a train bundle built under `use_rules(mesh)`) the whole leaves
        are read into host memory and placed on the shardings' mesh by
        `place(fsdp=True)`: a `MeshTree`, whose subtrees `state["params"]`
        gives; the mesh may differ from the one the state was saved from.
        Otherwise each leaf goes on `device`, or, when None, on the device
        of `like`'s leaf at the same path (the host for a "meta" leaf). A
        stored shape that differs from `like`'s raises ValueError."""
        if shardings is not None:
            whole = self.restore(step, like, device="cpu")
            return place(whole, shardings, leaves(shardings)[0].mesh, fsdp=True)
        path = os.path.join(self.dir, f"step_{step:08d}")
        if not os.path.exists(os.path.join(path, "COMMITTED")):
            raise FileNotFoundError(f"no committed checkpoint at {path}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, _SHARD)) as data:
            by_path = {e["path"]: (data[e["key"]], e["dtype"]) for e in manifest["leaves"]}
        out = []
        for p, leaf in flatten_with_paths(like):
            arr, logical = by_path[p]
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {p}: {arr.shape} vs {want}")
            dev = device if device is not None else getattr(leaf, "device", "cpu")
            if torch.device(dev).type == "meta":
                dev = "cpu"
            out.append(_from_numpy(arr, logical).to(dev))
        return unflatten(like, out)

    def restore_latest(self, like: Any, *, shardings: Any = None,
                       device=None) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, shardings=shardings, device=device)
