"""Meshes: named axes over a grid of devices — the port of the JAX package's
`launch/mesh.py`.

A `Mesh` is what `jax.sharding.Mesh` is to the reference: ordered axis names,
a shape, and a grid of devices. The port serves a mesh from one process, so
the grid holds `torch.device`s and a device may repeat: `[cpu] x n` for the
tests, `[cuda:0] x n` on the card, where every rank's shard, gather and step
runs for real on one device. A mesh of distinct devices can be built (the
layout search scores one) but is not served (`require_one_device`).
Nothing is built when this module is imported.

`make_production_mesh` (256 / 512 TPU chips) waits with the dry-run
(ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over a grid of devices (which may repeat)."""
    axis_names: Tuple[str, ...]
    devices: np.ndarray              # object array of torch.device, shape per axis

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, in axis order (as `jax.sharding.Mesh.shape`)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, **coords: int) -> torch.device:
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    @property
    def lead_device(self) -> torch.device:
        return self.devices.flat[0]

    @property
    def one_device(self) -> bool:
        """Every coordinate is the same device."""
        return len({str(d) for d in self.devices.flat}) == 1

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def require_one_device(mesh: Mesh, what: str) -> None:
    """Refuse a mesh of distinct devices: one process serves a mesh whose
    devices repeat, and a mesh of several cards waits for a multi-process
    torch.distributed backend."""
    if not mesh.one_device:
        raise NotImplementedError(
            f"{what}: {mesh!r} spans distinct devices; a mesh is served from one "
            f"process over one repeated device (e.g. [cuda:0] x n), and a mesh of "
            f"several cards needs the multi-process torch.distributed backend, not "
            f"ported yet")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `shape` over the first prod(shape) of `devices` (default:
    every visible CUDA device), laid out in row-major order."""
    devices = visible_devices() if devices is None else list(devices)
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"make_mesh: shape {tuple(shape)} needs {n} devices; got "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = torch.device(d)
    return Mesh(tuple(axis_names), grid.reshape(tuple(shape)))


def visible_devices() -> list:
    """Every visible CUDA device (none where there is no card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_host_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """`devices` (default: every visible CUDA device) as a (data, model) mesh
    with model = 1. Pass an explicit list, `[torch.device("cpu")] * n` say,
    for a mesh of repeated devices."""
    devices = visible_devices() if devices is None else list(devices)
    if not devices:
        raise ValueError("make_host_mesh: no devices (no CUDA card is visible; pass "
                         "`devices` explicitly, e.g. [torch.device('cpu')])")
    return make_mesh((len(devices), 1), ("data", "model"), devices)


def make_elastic_mesh(n_chips: int, *, model_parallel: int = 16,
                      chips_per_pod: int = 256, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from a live chip count: the model axis fixed, the remainder
    given to (pod, data). `devices` holds the chips (default: every visible
    CUDA device)."""
    if model_parallel < 1 or n_chips < 1 or n_chips % model_parallel:
        # ValueError, not assert: the check must survive `python -O`
        raise ValueError(
            f"make_elastic_mesh: n_chips ({n_chips}) must be a positive "
            f"multiple of model_parallel ({model_parallel})")
    rows = n_chips // model_parallel
    pods = max(n_chips // chips_per_pod, 1)
    while rows % pods:
        pods -= 1
    data = rows // pods
    if pods > 1:
        return make_mesh((pods, data, model_parallel), ("pod", "data", "model"), devices)
    return make_mesh((data, model_parallel), ("data", "model"), devices)
