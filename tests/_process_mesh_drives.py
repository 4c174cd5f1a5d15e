"""The drives of tests/test_torch_process_mesh.py, importable by its spawned
processes: they import torch and the port only (a child does not pay for
JAX), and the test module runs the same drives on one-process meshes.

`drive(mesh, models, shapes, extra)` is what each process of a process mesh
runs (`launch/mesh.py run_on_processes`): the serving drives of every model
on every mesh shape of its world (a second shape over the same processes is
a second `init_process_mesh`), the int8 pool, the prefix block matched
across data ranks, the bytes it holds, the collectives on plain tensors,
the lockstep check, the refusals, and `build_engine` under the process
group (the knobs, the layout search, the weights' digest check). Its result
is plain data and CPU tensors."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.placement import MeshTree
from repro_torch.distributed.sharding import Sharded
from repro_torch.launch import engine as port_engine
from repro_torch.launch.mesh import init_process_mesh, is_process_mesh
from repro_torch.models.config import get_config, reduced
from repro_torch.models.registry import get_model

ECFG = dict(num_slots=4, block_size=4, num_blocks=32, max_blocks_per_slot=8, prefill_chunk=8)


def prompts(vocab: int, n: int = 3) -> List[np.ndarray]:
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, int(rng.integers(5, 13))).astype(np.int32)
            for _ in range(n)]


class Logits:
    """The engine's model with every serving step's logits kept."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def serving_step(self, *a):
        out = self.model.serving_step(*a)
        self.logits.append(out[0].clone())
        return out


def pool_parts(eng) -> Dict[str, List[torch.Tensor]]:
    """Every pool leaf's parts as this process holds them, in model-rank
    order (one part on a process mesh)."""
    pool = eng.caches["paged"]
    view = pool.views[0] if isinstance(pool, MeshTree) else pool
    return {name: [p.clone() for p in leaf.parts] if isinstance(leaf, Sharded) else [leaf]
            for name, leaf in view.items()}


# the production features on one engine: the priority scheduler with weighted
# tenants under a budget, chunked-prefill admission, the prefix cache
SCHED = dict(scheduler="priority", chunked_prefill=True, prefix_cache=True,
             tenant_weights={"a": 1.0, "b": 2.0}, tenant_token_budget=40)


def serve(model, params, mesh, *, gen: int = 8, kv_smooth=None, n: int = 3,
          tenants: bool = False, **kw) -> Dict[str, Any]:
    """`n` prompts through one engine on `mesh` (None: one device), with
    `tenants` alternating between tenants "a" and "b" at priorities 0-2:
    tokens, every step's logits, the pool parts, the bytes of the params
    it holds."""
    eng = port_engine.ServingEngine(model, params, port_engine.EngineConfig(**{**ECFG, **kw}),
                                    mesh=mesh, device="cpu", kv_smooth=kv_smooth)
    return run(eng, gen=gen, n=n, tenants=tenants)


def run(eng, *, gen: int = 8, n: int = 3, tenants: bool = False) -> Dict[str, Any]:
    """`serve`'s drive on an engine already built."""
    model = eng.model
    eng.model = Logits(model)
    reqs = [eng.submit(p, gen, **(dict(tenant="ab"[i % 2], priority=i % 3) if tenants else {}))
            for i, p in enumerate(prompts(model.cfg.vocab, n))]
    eng.run()
    eng.assert_bounded_traces()
    return dict(tokens=[list(r.out_tokens) for r in reqs], logits=eng.model.logits,
                pool=pool_parts(eng), param_bytes=port_engine._tree_bytes(eng.params),
                eager_reason=eng.eager_reason)


def prefix_across_data_ranks(model, params, mesh, prefix_cache: bool) -> Dict[str, Any]:
    """A shared 8-token prompt prefix (two blocks) written by a data-rank-0
    slot and matched into a slot of the last data rank: A and C are
    admitted into slots 0 and 1 and prefilled; then B, opening with A's
    prefix, takes slot 2."""
    rng = np.random.default_rng(11)
    vocab = model.cfg.vocab
    shared = rng.integers(0, vocab, 8).astype(np.int32)
    a = np.concatenate([shared, rng.integers(0, vocab, 3).astype(np.int32)])
    b = np.concatenate([shared, rng.integers(0, vocab, 5).astype(np.int32)])
    c = rng.integers(0, vocab, 6).astype(np.int32)
    eng = port_engine.ServingEngine(model, params, port_engine.EngineConfig(
        **{**ECFG, "prefix_cache": prefix_cache}), mesh=mesh, device="cpu")
    eng.model = Logits(model)
    ra, rc = eng.submit(a, 8), eng.submit(c, 8)
    eng.step()
    eng.step()
    rb = eng.submit(b, 8)
    eng.step()
    slot_b = rb.slot
    eng.run()
    return dict(tokens=[list(r.out_tokens) for r in (ra, rb, rc)], logits=eng.model.logits,
                slots=(0, slot_b, 1), cached_tokens=eng.cache_stats["cached_tokens"],
                pool=pool_parts(eng))


def built_by_build_engine(params, world: int, shapes) -> Dict[str, Any]:
    """`build_engine` under the process group this process belongs to, for
    reduced llama2-7b with the LCD `params` (already clustered: nothing is
    compressed): for each shape of `shapes` one knob set, the other
    factor derived from the world size (a data axis of 1 pins
    model_parallel, else data_parallel), then neither (the layout search
    over the world's processes). Each: the mesh's type and shape and
    `run`'s drive."""
    out: Dict[str, Any] = {}
    cases = [("x".join(map(str, s)), dict(model_parallel=s[1]) if s[0] == 1
              else dict(data_parallel=s[0])) for s in shapes] + [("search", {})]
    for key, knobs in cases:
        eng, _ = port_engine.build_engine(
            "llama2-7b", lcd=True, params=params, device="cpu",
            ecfg=port_engine.EngineConfig(**ECFG, **knobs))
        out[key] = dict(process_mesh=is_process_mesh(eng.mesh),
                        shape=tuple(eng.mesh.devices.shape), world=world,
                        chosen=(eng.layout_report or {}).get("chosen"), **run(eng))
    return out


def weights_differ_on_the_last_rank(params, mesh) -> Optional[str]:
    """`build_engine` under the process group with the last rank's final
    norm changed in one element: the message each process raises, or
    None."""
    if mesh.rank == mesh.size - 1:
        scale = params["ln_final"]["scale"].clone()
        scale[0] += 1.0
        params = dict(params, ln_final=dict(scale=scale))
    try:
        port_engine.build_engine("llama2-7b", lcd=True, params=params, device="cpu",
                                 ecfg=port_engine.EngineConfig(**ECFG, model_parallel=1))
    except RuntimeError as e:
        return str(e)
    return None


def _collectives_on_plain_tensors(mesh) -> Dict[str, Any]:
    """all_gather over each axis group of a tensor holding the global rank,
    on dims 0 and 1, and a broadcast from each group's last member, with
    the calls and bytes counted."""
    collectives.reset_collective_counts()
    out: Dict[str, Any] = {}
    for axis in ("data", "model"):
        group = mesh.group(axis)
        t = torch.full((2, 3), float(mesh.rank), dtype=torch.bfloat16)
        out[axis] = dict(
            ranks=list(group.ranks),
            dim0=collectives.all_gather(t, group, 0),
            dim1=collectives.all_gather(t, group, 1),
            bcast=collectives.broadcast(torch.tensor([mesh.rank], dtype=torch.int64),
                                        group, group.size - 1))
    out["counts"] = collectives.collective_counts()
    return out


def _lockstep_raises(mesh) -> Optional[str]:
    """check_lockstep with the last rank's tokens changed: the message of
    the error each process raises, or None."""
    tokens = torch.tensor([3, 1, 4], dtype=torch.int32)
    if mesh.rank == mesh.size - 1:
        tokens = tokens + 1
    try:
        collectives.check_lockstep(tokens, mesh.group("world"))
    except RuntimeError as e:
        return str(e)
    return None


def _refusals(mesh) -> Dict[str, str]:
    """The NotImplementedError message of each path a process mesh refuses."""
    from repro_torch.launch.train import train
    out = {}
    for what, arch, kw in (("speculative", "llama2-7b", dict(speculative_k=3)),
                           ("moe", "phi3.5-moe-42b-a6.6b", {}),
                           ("recurrent", "rwkv6-1.6b", {}),
                           ("hybrid", "zamba2-1.2b", {}),
                           ("audio", "whisper-large-v3", {})):
        model = get_model(reduced(get_config(arch)))
        try:
            port_engine.ServingEngine(model, None, port_engine.EngineConfig(**{**ECFG, **kw}),
                                      mesh=mesh, device="cpu")
        except NotImplementedError as e:
            out[what] = str(e)
    try:
        train("llama2-7b", steps=1, device="cpu", mesh=mesh)
    except NotImplementedError as e:
        out["training"] = str(e)
    return out


def drive(mesh, models: Dict[str, Any], shapes, extra: Dict[str, Any]) -> Dict[str, Any]:
    """Every drive on each mesh shape of `shapes` (the first is `mesh`,
    the others made over the same processes): per shape, the coordinate,
    each model's `serve`, the int8 pool (`extra["int8"]`: the model's name
    and its smoothing vectors), the production features (`extra["sched"]`,
    `SCHED`), the prefix drive on meshes with a data
    axis of 2 or more, the collectives, the lockstep check; then the
    refusals, and `build_engine` under the process group (`extra["built"]`,
    reduced llama2-7b's LCD weights): `built_by_build_engine` and
    `weights_differ_on_the_last_rank`."""
    assert is_process_mesh(mesh)
    out: Dict[str, Any] = {}
    for shape in shapes:
        m = mesh if tuple(mesh.devices.shape) == tuple(shape) else init_process_mesh(
            shape, backend=mesh.backend, device="cpu")
        key = "x".join(map(str, shape))
        row: Dict[str, Any] = dict(coord=m.coord, rank=m.rank)
        for name, (cfg, params) in models.items():
            row[name] = serve(get_model(cfg), params, m)
        name, smooth = extra["int8"]
        cfg, params = models[name]
        row["int8"] = serve(get_model(cfg), params, m, kv_dtype="int8", kv_smooth=smooth)
        cfg, params = models[extra["sched"]]
        row["sched"] = serve(get_model(cfg), params, m, n=6, tenants=True, **SCHED)
        if shape[0] > 1:
            cfg, params = models[extra["prefix"]]
            row["prefix"] = {on: prefix_across_data_ranks(get_model(cfg), params, m, on)
                             for on in (True, False)}
        row["collectives"] = _collectives_on_plain_tensors(m)
        row["lockstep"] = _lockstep_raises(m)
        out[key] = row
    out["refusals"] = _refusals(mesh)
    params = models[extra["built"]][1]
    out["built"] = built_by_build_engine(params, mesh.size, shapes)
    out["weights_differ"] = weights_differ_on_the_last_rank(params, mesh)
    return out


def fails_on_rank_1(mesh):
    """Raises on rank 1 (run_on_processes' error path)."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.rank


def hangs_on_rank_1(mesh):
    """Sleeps two minutes on rank 1 (run_on_processes' timeout)."""
    if mesh.rank == 1:
        time.sleep(120)
    return mesh.rank
