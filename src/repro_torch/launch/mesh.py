"""Meshes: named axes over a grid of devices — the port of the JAX package's
`launch/mesh.py`.

A `Mesh` is what `jax.sharding.Mesh` is to the reference: ordered axis names,
a shape, and a grid of devices. It is served or trained on in one of two
ways:

  * from one process (`Mesh`): the grid's devices repeat, `[cpu] x n` for
    the tests, `[cuda:0] x n` on the card, and that process runs every
    rank's shard, gather and step for real on its one device
    (`require_one_device` refuses a one-process mesh of distinct devices);
  * by one torch.distributed process per coordinate (`ProcessMesh`, from
    `init_process_mesh`, or `run_on_processes` for tests and scripts): each
    process holds only its coordinate's shards on its own device and
    combines parts with the collectives of `distributed/collectives.py`
    over its axis groups. Its devices may be distinct cards (NCCL), or
    repeat (gloo: processes on the CPU, or sharing one card).

Meshes serve (`launch/engine.py ServingEngine(mesh=)`; a process mesh the
dense and vlm families) and train (`launch/train.py train(mesh=)`, the
elastic restart of `launch/elastic.py` over `make_elastic_mesh`; one
process only). Nothing is built when this module is imported.

`make_production_mesh` gives the reference's production shapes:

    single pod : (16, 16)      axes ("data", "model")          = 256 cards
    multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")   = 512 cards

over the visible cards by default, so where fewer are visible it raises
`make_mesh`'s "needs 256 devices" error rather than build anything smaller.
The dry run (`launch/dryrun.py`) passes `[torch.device("meta")] * n`: its
mesh places abstract tensors and runs nothing.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.collectives import AxisGroup, is_process_mesh


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


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh(Mesh):
    """A mesh served by one torch.distributed process per coordinate. The
    grid holds every rank's device (rank r runs coordinate r of the grid in
    row-major order, as `devices` is laid out); this process is `rank`, and
    `groups` holds its axis groups (`distributed/collectives.py
    AxisGroup`): per axis, the processes sharing its other coordinates, and
    "world", every process."""
    rank: int
    backend: str
    groups: Dict[str, Any]

    @property
    def coord(self) -> Dict[str, int]:
        """This process's coordinate, {axis: index}."""
        return {a: int(i) for a, i in zip(self.axis_names,
                                          np.unravel_index(self.rank, self.devices.shape))}

    @property
    def device(self) -> torch.device:
        """This process's device."""
        return self.devices.flat[self.rank]

    @property
    def lead_device(self) -> torch.device:
        # what a placement moves this process's shards to: its own device
        return self.device

    def group(self, axis: str):
        """This process's group over `axis` ("world": every process)."""
        return self.groups[axis]

    def __repr__(self):
        return (f"ProcessMesh({self.shape}, rank={self.rank} at {self.coord} on "
                f"{self.device}, backend={self.backend!r})")


def require_one_device(mesh: Mesh, what: str) -> None:
    """Refuse a one-process mesh of distinct devices: one process serves a
    mesh only over one repeated device; a mesh of several cards is a
    process mesh (`init_process_mesh`), one process per coordinate."""
    if not mesh.one_device and not is_process_mesh(mesh):
        raise NotImplementedError(
            f"{what}: {mesh!r} spans distinct devices; one process serves a mesh only "
            f"over one repeated device (e.g. [cuda:0] x n). Serve a mesh of several "
            f"cards as a multi-process mesh, one torch.distributed process per "
            f"coordinate: launch/mesh.py init_process_mesh (under torchrun) or "
            f"run_on_processes")


def refuse_process_mesh(mesh, what: str, item: str) -> None:
    """Raise NotImplementedError where `what` meets a process mesh: it waits
    for ROADMAP item `item`."""
    if is_process_mesh(mesh):
        raise NotImplementedError(
            f"{what} on a process mesh ({mesh!r}) is not ported yet (ROADMAP {item}); "
            f"serve it on one process over one repeated device")


def _axis_groups(shape: Tuple[int, ...], axis_names: Tuple[str, ...], rank: int,
                 backend: str) -> Dict[str, Any]:
    """This process's axis groups on a mesh of `shape`. torch.distributed
    makes a group collectively, so every process makes every group of every
    axis, in the same order, and keeps its own."""
    import torch.distributed as dist
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    mine = dict(zip(axis_names, np.unravel_index(rank, shape)))
    world = tuple(range(grid.size))
    groups = {"world": AxisGroup(world, rank, dist.group.WORLD if grid.size > 1 else None,
                                 backend)}
    for a, axis in enumerate(axis_names):
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in lines:
            ranks = tuple(int(r) for r in line)
            pg = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                groups[axis] = AxisGroup(ranks, ranks.index(rank), pg, backend)
        assert groups[axis].ranks[mine[axis]] == rank
    return groups


def init_process_mesh(shape: Sequence[int], axis_names: Sequence[str] = ("data", "model"),
                      *, backend: str, init_method: Optional[str] = None,
                      rank: Optional[int] = None, world_size: Optional[int] = None,
                      device=None, timeout_s: float = 600.0) -> ProcessMesh:
    """This process's coordinate of a mesh of `shape` over one
    torch.distributed process per coordinate, rank r at coordinate r in
    row-major order.

    `backend` is the caller's explicit choice: "nccl" where every rank has a
    card of its own, "gloo" on the CPU and where ranks share a card.
    `rank` / `world_size` default to torchrun's `RANK` / `WORLD_SIZE`;
    `init_method` to "env://" (torchrun's `MASTER_ADDR` / `MASTER_PORT`);
    the process group is made here unless one is already initialised (a
    second mesh over the same processes makes only its groups). `device`
    (default: "cuda:<LOCAL_RANK>") is this process's; every rank's is read
    back into the grid. A collective that waits longer than `timeout_s`
    fails."""
    import torch.distributed as dist
    from repro_torch.utils import resolve_device
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    n = int(np.prod(shape))
    if not dist.is_initialized():
        env = os.environ
        rank = int(env.get("RANK", 0)) if rank is None else rank
        world_size = int(env.get("WORLD_SIZE", n)) if world_size is None else world_size
        dev = resolve_device(device if device is not None
                             else f"cuda:{int(env.get('LOCAL_RANK', 0))}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dev = resolve_device(device if device is not None
                             else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        if dist.get_backend() != backend:
            raise ValueError(f"init_process_mesh: the process group runs "
                             f"{dist.get_backend()!r}; asked for {backend!r}")
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != n:
        raise ValueError(f"init_process_mesh: shape {shape} needs {n} processes; the "
                         f"process group has {world}")
    names: List[Any] = [None] * world
    dist.all_gather_object(names, str(dev))
    grid = np.empty(world, dtype=object)
    for i, d in enumerate(names):
        grid[i] = torch.device(d)
    groups = _axis_groups(shape, axis_names, rank, backend)
    return ProcessMesh(axis_names, grid.reshape(shape), rank, backend, groups)


def _to_cpu(x):
    """A result with every tensor on the CPU (dicts, lists, tuples walked)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _process_main(rank, fn, shape, backend, devices, init_method, timeout_s, args,
                  results) -> None:
    """A `run_on_processes` child, on one intra-op thread: its mesh,
    `fn(mesh, *args)`, the result (pickled, tensors on the CPU) or the
    traceback put on `results`."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        mesh = init_process_mesh(shape, backend=backend, init_method=init_method, rank=rank,
                                 world_size=len(devices), device=devices[rank],
                                 timeout_s=timeout_s)
        out = fn(mesh, *args)
        results.put((rank, "ok", pickle.dumps(_to_cpu(out))))
    except (Exception, SystemExit):
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_on_processes(fn: Callable, shape: Sequence[int], *, backend: str,
                     devices: Sequence, timeout_s: float, args: Sequence = (),
                     init_method: Optional[str] = None) -> List[Any]:
    """`fn(mesh, *args)` in one spawned process per coordinate of a (data,
    model) mesh of `shape` (`init_process_mesh`; process r on `devices[r]`),
    its results in rank order. `fn` and `args` must pickle (a module-level function; CPU
    tensors pass through shared memory); a result comes back pickled, its
    tensors moved to the CPU.

    Spawn only: a forked child of a process that has touched CUDA breaks.
    The rendezvous is a file in a fresh temporary directory unless
    `init_method` says otherwise, and each child runs one intra-op thread
    (the test suite's workers share the cores). A child's exception fails the call with its traceback, and a
    child that has not finished within `timeout_s` is killed and fails it:
    a collective that deadlocks never hangs the caller. Every child is
    stopped before this returns or raises."""
    import torch.multiprocessing as mp
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if len(devices) != n:
        raise ValueError(f"run_on_processes: shape {shape} needs {n} devices; got "
                         f"{len(devices)}")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="repro_torch_rdv_")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    devices = [str(torch.device(d)) for d in devices]
    procs = [ctx.Process(target=_process_main, daemon=True,
                         args=(r, fn, shape, backend, devices, init_method, timeout_s,
                               tuple(args), results))
             for r in range(n)]
    done: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(done) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_on_processes: rank(s) {sorted(set(range(n)) - set(done))} of "
                    f"{shape} did not finish within {timeout_s} s; killed")
            try:
                r, status, payload = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_on_processes: rank {dead[0][0]} exited with "
                                       f"code {dead[0][1]} before its result")
                continue
            if status == "error":
                raise RuntimeError(f"run_on_processes: rank {r} of {shape} failed:\n{payload}")
            done[r] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(n)]


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


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The production mesh (the JAX package's `make_production_mesh`):
    (16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model") with `multi_pod`, over `devices` (default: every visible CUDA
    device)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


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
