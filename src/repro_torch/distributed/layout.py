"""Mesh-layout selection for sharded serving — the port of the JAX package's
`distributed/layout.py`.

Given a list of devices, `choose_layout` scores every (data, model)
factorization on ONE representative serving step, the width-1 pure-decode
step a deployment spends its life in, and returns the cheapest. The
reference lowers that step with its shardings attached and scores the
partitioned XLA module with its HLO cost model (`distributed/hlo_cost.py`,
`hlo_analysis.py`); the port has no compiler module to read, so its scorer
is their analytic twin over the same placements: per layer and per rank,
the LUT projections' 2·M·K·N operations on each rank's column shard and
their packed-code bytes, B5's 4·D operations per visible (query, key) pair
and its pool bytes over the whole block table, the replicated tensors
(norm scales, the head), and the bytes each gather moves between ranks.
The busiest rank sets the time:

    t = ops / PEAK_OPS  +  bytes / HBM_BW  +  gather_bytes / LINK_BW

The constants are one H100 SXM5 80GB (700 W) from its data sheet, not
measurements; only their ratios drive the argmin.

`serving_shardings` is the shared helper: the engine places its params and
pools with it, and the scorer reads the same placements.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.core.api import is_clustered
from repro_torch.distributed.sharding import (auto_shard, logical_to_spec,
                                              named_sharding, parse_names, use_rules)

# One H100 SXM5 80GB at 700 W (NVIDIA's data sheet): dense bf16 tensor-core
# operations per second, HBM3 bytes per second, NVLink bytes per second in
# one direction. Scoring constants, not measurements.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

# The port's serving placements where they differ from the reference's
# names (ROADMAP C): `wo` and `w_down` are cut by their OUTPUT dim, so every
# LUT projection sums its whole canonical K order on its own columns (a K
# cut would split each way's fmaf chain), and the vocab tables stay whole,
# so the head is one product over every row, as on one device.
SERVE_RULES = {"embed_out": "model"}
_SERVE_NAMES = {("blocks", "attn", "wo"): "layers,.,embed_out",
                ("blocks", "mlp", "w_down"): "layers,.,embed_out",
                ("embed",): ".,.", ("lm_head",): ".,."}


def candidate_layouts(n_devices: int):
    """Every (data, model) factorization of `n_devices`, pure-DP first."""
    out = []
    for model in range(1, n_devices + 1):
        if n_devices % model == 0:
            out.append((n_devices // model, model))
    return out


def cache_shardings(model, caches, sr=None):
    """NamedShardings for an engine cache dict ({kind: tree}) from the
    family's declared logical names. Keys a family adds beyond its declared
    names replicate."""
    out: Dict[str, Any] = {}
    for kind, cache in caches.items():
        nm = dict(model.seq_caches[kind].names)
        out[kind] = {
            k: named_sharding(
                tuple(v.shape),
                parse_names(nm[k]) if k in nm else (None,) * len(v.shape),
                sr)
            for k, v in cache.items()}
    return out


def serving_names(model):
    """`model.names()` with the port's serving placements (`_SERVE_NAMES`);
    place under `use_rules(mesh, SERVE_RULES, fsdp=False)`."""
    names = model.names()
    for path, nm in _SERVE_NAMES.items():
        node = names
        for key in path[:-1]:
            node = node.get(key, {})
        if path[-1] in node:
            node[path[-1]] = nm
    return names


def serving_shardings(model, params, caches, sr=None, names=None):
    """(param_shardings, cache_shardings) for a serving deployment: params
    through the ClusteredTensor-aware `auto_shard` (over `names`, default
    `model.names()`), pools through the family's cache names. Call under
    `use_rules(mesh, fsdp=False)`."""
    return auto_shard(params, model.names() if names is None else names, sr), \
        cache_shardings(model, caches, sr)


def _cut_on_model(spec) -> Optional[int]:
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if "model" in axes:
            return i
    return None


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def score_layout(model, params, ecfg, mesh) -> Dict[str, Any]:
    """Roofline score of one mesh candidate: the width-1 decode step of
    `ecfg.num_slots` slots on the busiest rank, every slot's keys over the
    whole block table (`ecfg.max_seq`)."""
    cfg = model.cfg
    n_data, n_model = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    s_all = ecfg.num_slots
    elt = cfg.torch_dtype.itemsize
    with use_rules(mesh, SERVE_RULES, fsdp=False):
        pshard = auto_shard(params, serving_names(model))
        s_rank = s_all // n_data if logical_to_spec((s_all,), ("slots",))[0] else s_all
        kv_cut = _cut_on_model(logical_to_spec(
            (cfg.n_layers, ecfg.num_blocks, ecfg.block_size, cfg.n_kv_heads, cfg.hd),
            parse_names(model.seq_caches["paged"].names["k"]))) is not None
    flops = nbytes = coll = 0.0
    counts: Dict[str, int] = {}

    def gathered(nbytes_whole, times=1, ranks=n_model):
        nonlocal coll
        if ranks > 1:
            coll += times * nbytes_whole * (ranks - 1) / ranks
            counts["all-gather"] = counts.get("all-gather", 0) + times

    shard_of = dict(_leaves(pshard))
    for path, leaf in _leaves(params):
        ns = shard_of[path]
        if is_clustered(leaf):
            k, n = leaf.smooth.shape[-1], leaf.codes.shape[-1]
            reps = leaf.codes.numel() // (leaf.codes.shape[-2] * n)
            cut = _cut_on_model(ns.codes.spec) is not None
            part = n_model if cut else 1
            flops += 2.0 * s_rank * k * (n // part if cut else n) * reps
            packed = leaf.packed if leaf.packed is not None else leaf.codes
            nbytes += packed.numel() * packed.element_size() / part
            nbytes += 2 * 4 * leaf.smooth.numel()
            nbytes += reps * s_rank * (k * elt + (n // part) * 4)
        elif path == ("lm_head",) or (path == ("embed",) and cfg.tie_embeddings):
            # the head: one product over every slot's row, whole on each rank
            d, v = cfg.d_model, cfg.padded_vocab
            flops += 2.0 * s_all * d * v
            nbytes += leaf.numel() * leaf.element_size() + s_all * v * elt
        elif path == ("embed",):
            nbytes += s_rank * cfg.d_model * elt
        else:
            part = n_model if _cut_on_model(ns.spec) is not None else 1
            nbytes += leaf.numel() * leaf.element_size() / part
    # paged attention (B5): every slot's keys over the whole block table
    heads = cfg.n_heads_eff // n_model if kv_cut else cfg.n_heads_eff
    kv_heads = cfg.n_kv_heads // n_model if kv_cut else cfg.n_kv_heads
    pool_elt = 1 if ecfg.kv_dtype == "int8" else elt
    keys = ecfg.max_seq
    flops += cfg.n_layers * 4.0 * cfg.hd * heads * keys * s_rank
    nbytes += cfg.n_layers * s_rank * 2 * keys * kv_heads * cfg.hd * pool_elt
    # the gathers of a layer: the attention output (or q, k, v where the
    # pool stays whole), wo's columns, the MLP's hidden, w_down's columns;
    # then every data rank's hidden rows for the head
    row = s_rank * elt
    if kv_cut:
        gathered(row * cfg.q_dim_eff, cfg.n_layers)
    else:
        gathered(row * (cfg.q_dim_eff + 2 * cfg.kv_dim), cfg.n_layers)
    gathered(row * cfg.d_model, 2 * cfg.n_layers)
    gathered(row * cfg.d_ff, cfg.n_layers)
    gathered(s_all * cfg.d_model * elt, 1, n_data)
    t = flops / PEAK_FLOPS + nbytes / HBM_BW + coll / LINK_BW
    return {"flops": flops, "bytes": nbytes, "coll_bytes": coll,
            "coll_counts": counts, "t_model_s": t}


def choose_layout(model, params, ecfg, *, devices=None) -> Tuple[Any, Dict[str, Any]]:
    """(mesh, report): the roofline-cheapest (data, model) mesh over
    `devices` (default: every visible CUDA device). The report records every
    candidate's score, so a deployment's layout choice is auditable."""
    from repro_torch.launch.mesh import make_mesh, visible_devices
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    report: Dict[str, Any] = {"devices": n, "candidates": {}}
    best: Optional[Tuple[float, Any, str]] = None
    for data, mp in candidate_layouts(n):
        mesh = make_mesh((data, mp), ("data", "model"), devices)
        row = score_layout(model, params, ecfg, mesh)
        key = f"{data}x{mp}"
        report["candidates"][key] = {
            k: (round(v, 9) if isinstance(v, float) else v) for k, v in row.items()}
        if best is None or row["t_model_s"] < best[0]:
            best = (row["t_model_s"], mesh, key)
    assert best is not None
    report["chosen"] = best[2]
    return best[1], report
