"""Mesh-layout selection for sharded serving — the port of the JAX package's
`distributed/layout.py`.

Given a list of devices, `choose_layout` scores every (data, model)
factorization on ONE representative serving step, the width-1 pure-decode
step a deployment spends its life in, and returns the cheapest. The
reference lowers that step with its shardings attached and scores the
partitioned XLA module with its HLO cost model (`distributed/hlo_cost.py`,
`hlo_analysis.py`); the port has no compiler module to read, so its scorer
is their analytic twin over the same placements, for every family: per
layer and per rank, the LUT projections' 2·M·K·N operations on each rank's
column shard and their packed-code bytes, an MoE layer's experts over the
step's tokens, B5's 4·D operations per visible (query, key) pair and its
pool bytes over the whole block table, the slot state a step reads and
writes (recurrent states, whisper's self and cross K/V), the replicated
tensors (norm scales, the head), and the bytes each gather moves between
ranks. The busiest rank sets the time:

    t = ops / PEAK_OPS  +  bytes / HBM_BW  +  gather_bytes / LINK_BW

The constants are one H100 SXM5 80GB (700 W) from its data sheet
(`distributed/cost.py`, NVLink for the links), not measurements; only their
ratios drive the argmin.

`serving_shardings` is the shared helper: the engine places its params and
pools with it, and the scorer reads the same placements.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.core.api import is_clustered
from repro_torch.distributed.cost import HBM_BW, PEAK_FLOPS, cut_dim, dict_leaves, spec_parts
from repro_torch.distributed.cost import NVLINK_BW as LINK_BW
from repro_torch.distributed.sharding import (auto_shard, logical_to_spec,
                                              named_sharding, parse_names, use_rules)

# The port's serving placements where they differ from the reference's
# names (ROADMAP C), one rule for every family (`serving_names`): a
# projection the reference cuts along K (`q_dim`, `ff` or `ssm_inner` into
# `embed`: attention and MLP outputs, rwkv6's `wo` / `cm.wv`, zamba2's
# `w_out`, whisper's `wo` / `w_down`) is cut by its OUTPUT dim instead, so
# every LUT projection sums its whole canonical K order on its own columns
# (a K cut would split each way's fmaf chain); a stacked expert weight is
# cut on its experts or not at all (never on `ff`, which the reference's
# fallback takes when the model axis does not divide the experts); the
# vocab tables stay whole, so the head is one product over every row, as on
# one device.
SERVE_RULES = {"embed_out": "model"}
_K_NAMES = ("q_dim", "ff", "ssm_inner")


def _serve_name(names: str) -> str:
    nm = names.split(",")
    if "experts" in nm:
        return ",".join(n if n in ("layers", "experts") else "." for n in nm)
    if "vocab" in nm:
        return ",".join("." for _ in nm)
    if len(nm) >= 2 and nm[-1] == "embed" and nm[-2] in _K_NAMES:
        return ",".join(nm[:-2] + [".", "embed_out"])
    return names


def _serve_cache_name(names: str) -> str:
    """A serving cache's names: a slot's keys (`seq_kv`, whisper's self
    K/V) stay whole, so the cache is cut on its heads, where the reference's
    rules would give the model axis to the key positions (one softmax over
    every key of a row, summed in one order)."""
    return ",".join("." if n == "seq_kv" else n for n in names.split(","))


def candidate_layouts(n_devices: int):
    """Every (data, model) factorization of `n_devices`, pure-DP first."""
    out = []
    for model in range(1, n_devices + 1):
        if n_devices % model == 0:
            out.append((n_devices // model, model))
    return out


def cache_shardings(model, caches, sr=None):
    """NamedShardings for an engine cache dict ({kind: tree}) from the
    family's declared logical names, a slot's keys kept whole
    (`_serve_cache_name`). Keys a family adds beyond its declared names
    replicate."""
    out: Dict[str, Any] = {}
    for kind, cache in caches.items():
        nm = dict(model.seq_caches[kind].names)
        out[kind] = {
            k: named_sharding(
                tuple(v.shape),
                parse_names(_serve_cache_name(nm[k])) if k in nm else (None,) * len(v.shape),
                sr)
            for k, v in cache.items()}
    return out


def serving_names(model):
    """`model.names()` with the port's serving placements (`_serve_name`);
    place under `use_rules(mesh, SERVE_RULES, fsdp=False)`."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return _serve_name(tree)
    return walk(model.names())


def serving_shardings(model, params, caches, sr=None, names=None):
    """(param_shardings, cache_shardings) for a serving deployment: params
    through the ClusteredTensor-aware `auto_shard` (over `names`, default
    `model.names()`), pools through the family's cache names. Call under
    `use_rules(mesh, fsdp=False)`."""
    return auto_shard(params, model.names() if names is None else names, sr), \
        cache_shardings(model, caches, sr)


def _uses(model, path) -> int:
    """How often a decode step runs a leaf's layer slice: zamba2's shared
    block once per site; whisper's encoder and cross K / V projections
    never (they run once a request, at admission); everything else once."""
    if path[0] == "shared":
        from repro_torch.models.zamba2 import n_sites
        return n_sites(model.cfg)
    if path[0] == "enc" or (path[-2:-1] == ("cross_attn",) and path[-1] in ("wk", "wv")):
        return 0
    return 1


def _head_mixers(model):
    """The mixers a decode step runs per model rank over its heads wherever
    their cache is cut on heads, as (params subtree, the projections whose
    column shards feed the mixer ungathered, the cache leaf (kind, name)
    whose cut decides, the width gathered after it, runs a step). Where that
    cache stays whole, those projections' outputs are gathered instead and
    the mixer runs whole."""
    cfg = model.cfg
    q, d, lay = cfg.q_dim_eff, cfg.d_model, cfg.n_layers
    if cfg.family == "rwkv":
        return [(("blocks", "tm"), ("wr", "wk", "wv"), ("slot", "wkv"), d, lay)]
    if cfg.family == "linear_attn":
        return [(("blocks", "attn"), ("wq", "wk", "wv"), ("slot", "s"), d, lay)]
    if cfg.family == "hybrid":
        from repro_torch.models.zamba2 import n_sites
        return [(("shared", "attn"), ("wq", "wk", "wv"), ("paged", "k"), q, n_sites(cfg)),
                ((), (), ("slot", "conv"), cfg.d_inner, lay),     # the conv's channels
                ((), (), ("slot", "ssm"), cfg.d_inner, lay)]      # the SSD's heads
    if cfg.family == "audio":
        return [(("dec", "blocks", "self_attn"), ("wq", "wk", "wv"), ("slot", "k"), q, lay),
                (("dec", "blocks", "cross_attn"), ("wq",), ("slot", "ck"), q, lay)]
    return [(("blocks", "attn"), ("wq", "wk", "wv"), ("paged", "k"), q, lay)]


def score_layout(model, params, ecfg, mesh) -> Dict[str, Any]:
    """Roofline score of one mesh candidate: the width-1 decode step of
    `ecfg.num_slots` slots on the busiest rank, for every family:

      * a LUT projection on its rank's shard: 2·M·K·N operations, its packed
        bytes, its smoothing vectors and its activations; a float weight:
        its bytes (its products are not scored: the decode step is bound by
        its bytes);
      * an MoE layer's stacked experts, E/m a model rank where the model
        axis cuts them: each expert over its places in every group of the
        step's tokens (`layers.moe_capacity`), 2·K·N operations a place,
        each clustered expert weight resolved to a dense one (written and
        read back); the dispatch and combine products over every token;
      * the head whole on every rank, over every slot's row;
      * the caches: a paged pool's keys over the whole block table
        (`ecfg.max_seq`, zamba2's sites too), 4·D operations per visible
        (query, key) pair; a slot's keys and cross keys (whisper) read
        whole; a recurrent state read and written, ≈ 4 operations an
        element; each cut by heads where the model axis divides them;
      * the gathers, each what the step gathers: a column-cut projection's
        output (a gated MLP's gate and up each), except the projections
        feeding a mixer that runs per rank over its heads
        (`_head_mixers`), whose output is gathered instead; an MoE layer's
        rows over the data axes (in and back out) and its experts' outputs
        over the model axis; every data rank's rows for the head.
    """
    from repro_torch.models.layers import moe_capacity, moe_groups
    cfg = model.cfg
    n_data = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    n_model = mesh.shape.get("model", 1)
    s_all = ecfg.num_slots
    elt = cfg.torch_dtype.itemsize
    caches = model.init_seq_caches(
        num_blocks=ecfg.num_blocks, block_size=ecfg.block_size, num_slots=s_all,
        max_seq=ecfg.max_seq, kv_dtype=ecfg.kv_dtype if "paged" in model.seq_caches else None,
        device="meta")
    with use_rules(mesh, SERVE_RULES, fsdp=False):
        pshard = auto_shard(params, serving_names(model))
        cshard = cache_shardings(model, caches)
        s_rank = s_all // spec_parts(logical_to_spec((s_all,), ("slots",)), mesh.shape)
    flops = nbytes = coll = 0.0
    counts: Dict[str, int] = {}

    def gathered(nbytes_whole, times=1, ranks=n_model):
        nonlocal coll
        if ranks > 1 and times:
            coll += times * nbytes_whole * (ranks - 1) / ranks
            counts["all-gather"] = counts.get("all-gather", 0) + times

    def heads_cut(kind, name):
        return cut_dim(cshard[kind][name].spec) is not None

    # the projections whose column shards feed a mixer per rank over its heads
    ungathered = set()
    for where, projs, (kind, name), width, runs in _head_mixers(model):
        if heads_cut(kind, name):
            ungathered.update(where + (p,) for p in projs)
            gathered(s_rank * width * elt, runs)
    n_exp = cfg.n_experts
    if n_exp:
        groups, sg = moe_groups(s_all)
        cap = moe_capacity(sg, cfg.moe_topk, n_exp)
    shard_of = dict(dict_leaves(pshard))
    names_of = dict(dict_leaves(model.names()))
    head = ("lm_head",) if "lm_head" in params else None
    for path, leaf in dict_leaves(params):
        ns, uses = shard_of[path], _uses(model, path)
        names = names_of[path].split(",")
        if head is None and "vocab" in names:
            head = path                     # a tied head: the vocab table
        if path == head:
            d, v = cfg.d_model, cfg.padded_vocab
            flops += 2.0 * s_all * d * v
            nbytes += leaf.numel() * leaf.element_size() + s_all * v * elt
            continue
        if "vocab" in names or path[-1] == "pos_embed":
            nbytes += s_rank * cfg.d_model * elt       # the embedding rows
            continue
        clustered = is_clustered(leaf)
        w = leaf.codes if clustered else leaf
        cut = cut_dim(ns.codes.spec if clustered else ns.spec)
        part = n_model if cut is not None else 1
        matrix = [nm for nm in names if nm not in ("layers", "experts")]
        if (len(matrix) == 2 and cut == w.ndim - 1 and path not in ungathered
                and "experts" not in names):
            # a column-cut projection: its output gathered for the next op
            gathered(s_rank * w.shape[-1] * elt, uses * (w.numel() // w.shape[-2:].numel()))
        if not clustered:
            nbytes += uses * leaf.numel() * leaf.element_size() / part
        else:
            packed = leaf.packed if leaf.packed is not None else leaf.codes
            nbytes += uses * packed.numel() * packed.element_size() / part
            # smoothing vectors (the input dim's): cut only with an expert stack
            s_part = part if "experts" in names else 1
            nbytes += uses * 2 * 4 * leaf.smooth.numel() / s_part
        if clustered:                       # codes may pack K: K from the smoothing vector
            k, n = leaf.smooth.shape[-1], w.shape[-1]
        elif w.ndim >= 2:
            k, n = w.shape[-2:]
        if "experts" in names:
            # (layers, E, K, N): E/m experts a rank, each over g · cap places
            e_rank, lay = n_exp // part, w.shape[0]
            places = groups * cap
            flops += 2.0 * lay * e_rank * places * k * n
            nbytes += lay * e_rank * places * (k + n) * elt
            if clustered:
                nbytes += lay * e_rank * 2 * k * n * elt          # the resolved weight
            continue
        if not clustered:
            continue
        stack = w.numel() // w.shape[-2:].numel()
        n_rank = n // part if cut == w.ndim - 1 else n
        flops += uses * 2.0 * s_rank * k * n_rank * stack
        nbytes += uses * stack * s_rank * (k * elt + n_rank * 4)
    if n_exp:
        lay, d = cfg.n_layers, cfg.d_model
        flops += lay * 4.0 * s_all * n_exp * cap * d          # dispatch and combine
        gathered(s_all * d * elt, 2 * lay, n_data)              # rows in, rows out
        gathered(n_exp * groups * cap * d * elt, lay)           # the experts' outputs
    group = cfg.n_heads_eff // max(cfg.n_kv_heads, 1)
    for kind, cache in caches.items():
        cnames = dict(model.seq_caches[kind].names)
        for name, leaf in cache.items():
            nm = cnames.get(name, "").split(",")
            part = n_model if heads_cut(kind, name) else 1
            size = leaf.numel() * leaf.element_size() / part
            if kind == "paged":
                if "blocks" not in nm:
                    nbytes += size                               # smoothing vectors
                    continue
                rows = ecfg.num_blocks * ecfg.block_size
                seen = size / rows * s_rank * ecfg.max_seq       # every slot's keys
                nbytes += seen
                if name in ("k", "v"):
                    flops += 2.0 * group * seen / leaf.element_size()
                continue
            per_slot = size / leaf.shape[1] * s_rank
            if "seq_kv" in nm or "enc_seq" in nm:
                nbytes += per_slot                               # keys read whole
                flops += 2.0 * per_slot / leaf.element_size()
            else:
                nbytes += 2 * per_slot                           # state read, written
                flops += 4.0 * per_slot / leaf.element_size()
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
