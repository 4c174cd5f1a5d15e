"""Roofline terms of a step on the H100 — the port's counterpart of the JAX
package's `distributed/hlo_analysis.py` (the `Roofline` record, the hardware
constants, `model_flops_train` / `model_flops_decode`) and
`distributed/hlo_cost.py` (the per-device count of a step's operations,
bytes and collectives).

The reference lowers and compiles each step on 512 host devices and walks
the optimized HLO with trip counts. The port has no compiler to ask, so
its count is analytic: the step the port runs, read off the model's
parameter table, the step's shapes and the placements, for the busiest
rank of the mesh (every count here is per rank):

  * train (`launch/steps.py build_train_step`'s mesh step): each data rank
    gathers the FSDP-cut params (all-gather over the data axes; a weight
    stored cut along K is re-cut by its output columns, an all-to-all over
    the model axis), runs the forward and backward of its rows on the
    compute layout (`distributed/layout.py serving_names`: each projection
    on its column shard, its output gathered over the model axis, except
    where a mixer runs per rank over its heads; the vocab tables whole),
    sums the gradients over the data ranks (reduce-scatter where the leaf
    is FSDP-cut, else all-reduce) and runs Adam on its parts. Under
    `remat_policy="nothing"` every layer's forward runs twice
    (`models/transformer.py remat_call`); "dots" saves the projections'
    outputs and recomputes the rest; a sequence longer than the attention
    chunk (1024) recomputes each chunk's attention once more. The backward
    costs twice the forward's products and bytes; a column-cut product's
    input gradient is summed over the model axis (all-reduce);
  * prefill (`build_prefill_step`): the same forward under no_grad, the
    full logits computed as the port computes them (the step then keeps
    the last position's);
  * decode: the engine's width-1 step scored by `distributed/layout.py
    score_layout` (its values pinned by the layout tests), plus the float
    projections' products that `score_layout` leaves out;
  * attention as the port computes it (`models/layers.py _attn_chunk`):
    every (query, key) pair of each chunk, 4·D f32 operations a pair and
    head, and the pair's f32 score traffic (`ATTN_PAIR_BYTES`); the
    recurrent families' chunked forms (`models/linear_attn.py`, f32) by
    their chunk; an MoE layer's experts by capacity (`layers.moe_capacity`)
    over the whole token set of the step, as the port routes it.

Products are counted at the dtype they run in: the model dtype's products
on the tensor cores (`PEAK_FLOPS`, bf16) unless the model is f32, and every
f32 product (an f32 model's, attention's scores, the routing and dispatch,
the chunked scans, the decode kernels) at the CUDA cores' f32 rate
(`PEAK_FLOPS_F32`): the port runs f32 products in full f32, TF32 off.

A collective's bytes are what one rank sends over its links: an all-gather
or reduce-scatter of W bytes over g ranks moves W·(g-1)/g, an all-reduce
twice that, an all-to-all of a rank's W bytes W·(g-1)/g. Its time is those
bytes over the links its group spans (`link_bw`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch

# One NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit: NVIDIA's data
# sheet figures, not measurements.
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12          # dense bf16 on the tensor cores, operations / s
PEAK_FLOPS_F32 = 67e12       # f32 on the CUDA cores, operations / s
HBM_BW = 3.35e12             # HBM3, bytes / s
HBM_BYTES = 80e9             # a card's memory
NVLINK_BW = 450e9            # NVLink, bytes / s in one direction, between the
NODE_CARDS = 8               # cards of one 8-card node
# ASSUMPTION, not a data-sheet figure for the card: a card's share of the
# network once a collective's group spans nodes, one 400 Gb/s NIC a card
# as in an HGX H100 system, bytes / s in one direction.
NET_BW = 50e9

PEAKS = {"bf16": PEAK_FLOPS, "f32": PEAK_FLOPS_F32}

# bytes a (query, key) pair of one head moves through `_attn_chunk`'s
# forward: the f32 scores written, masked, their max read, shifted,
# exponentiated, summed, divided and read by the value product (12 passes
# of 4 bytes). A flash kernel (B9) keeps them on chip.
ATTN_PAIR_BYTES = 48
ATTN_CHUNK = 1024            # `layers.attention`'s query chunk
SCAN_CHUNKS = {"rwkv": 32, "linear_attn": 32, "hybrid": 64}   # linear_attn.py's chunks
ADAM_BYTES = 28              # f32 bytes an element beyond the param's own (read, written)


def model_flops_train(n_active_params: int, tokens: int) -> float:
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: int, tokens: int) -> float:
    return 2.0 * n_active_params * tokens


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-rank operations
    hbm_bytes: float             # per-rank HBM bytes
    coll_bytes: float            # per-rank collective wire bytes
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    collectives: CollectiveStats
    model_flops: float = 0.0     # 6·N·D (train) or 2·N·D, the whole program
    peak_memory: Optional[int] = None

    @property
    def t_step(self) -> float:   # optimistic overlap model: max of terms
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_frac(self) -> float:
        if not self.model_flops:
            return 0.0
        return self.model_flops / max(self.flops * self.chips, 1.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time, against the
        card's bf16 peak."""
        if not self.model_flops:
            return 0.0
        return self.model_flops / (self.t_step * self.chips * PEAK_FLOPS)

    def row(self) -> Dict:
        return {
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "useful_flop_frac": self.useful_flop_frac, "mfu": self.mfu,
            "flops_per_dev": self.flops, "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
        }


def link_bw(mesh_shape: Dict[str, int], axes: Sequence[str]) -> float:
    """The rate a rank's share of a collective over `axes` moves at: NVLink
    where the group's cards lie in one node, the network share otherwise.
    Cards are numbered row-major over the mesh, NODE_CARDS to a node."""
    names = list(mesh_shape)
    stride, strides = 1, {}
    for a in reversed(names):
        strides[a] = stride
        stride *= mesh_shape[a]
    cards = [0]
    for a in axes:
        cards = [c + i * strides[a] for c in cards for i in range(mesh_shape.get(a, 1))]
    return NVLINK_BW if len({c // NODE_CARDS for c in cards}) == 1 else NET_BW


@dataclasses.dataclass
class Cost:
    """A rank's count: operations by the dtype they run in, HBM bytes (of
    which `s2_bytes` are attention's S x S score traffic), collective
    wire bytes and counts by kind, and the collectives' time."""
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    s2_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    t_collective: float = 0.0

    def ops(self, n: float, dtype: str) -> None:
        self.flops[dtype] = self.flops.get(dtype, 0.0) + n

    def collective(self, kind: str, whole: float, group: int, bw: float,
                   times: float = 1) -> None:
        """`times` collectives of `kind` over `group` ranks, each of `whole`
        bytes (the gathered or reduced tensor; an all-to-all's rank part)."""
        if group <= 1 or not times or not whole:
            return
        wire = times * whole * (group - 1) / group * (2 if kind == "all-reduce" else 1)
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + wire
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + times
        self.t_collective += wire / bw

    def __iadd__(self, o: "Cost") -> "Cost":
        for mine, theirs in ((self.flops, o.flops), (self.coll_bytes, o.coll_bytes),
                             (self.coll_counts, o.coll_counts)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0.0) + v
        self.hbm_bytes += o.hbm_bytes
        self.s2_bytes += o.s2_bytes
        self.t_collective += o.t_collective
        return self

    def __add__(self, o: "Cost") -> "Cost":
        out = self.scaled(1.0)
        out += o
        return out

    def scaled(self, f: float) -> "Cost":
        return Cost({k: v * f for k, v in self.flops.items()}, self.hbm_bytes * f,
                    self.s2_bytes * f, {k: v * f for k, v in self.coll_bytes.items()},
                    {k: v * f for k, v in self.coll_counts.items()}, self.t_collective * f)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def t_compute(self) -> float:
        return sum(v / PEAKS[k] for k, v in self.flops.items())


def roofline(cost: Cost, chips: int, model_flops: float = 0.0, *,
             without_s2: bool = False) -> Roofline:
    """The three terms of `cost` (with `without_s2`, its S x S score traffic
    taken out: the step as a flash kernel would run it)."""
    hbm = cost.hbm_bytes - (cost.s2_bytes if without_s2 else 0.0)
    t_c, t_m, t_x = cost.t_compute, hbm / HBM_BW, cost.t_collective
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    coll = CollectiveStats({k: float(v) for k, v in cost.coll_bytes.items()},
                           {k: int(round(v)) for k, v in cost.coll_counts.items()})
    return Roofline(cost.total_flops, hbm, coll.total_bytes, chips, t_c, t_m, t_x, dom,
                    coll, model_flops)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def spec_parts(spec, mesh_shape: Dict[str, int]) -> int:
    """The number of parts a spec cuts a tensor into."""
    n = 1
    for entry in spec or ():
        for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            n *= mesh_shape.get(a, 1)
    return n


def bytes_per_rank(tree, shardings, mesh_shape: Dict[str, int]) -> int:
    """The JAX package's `bytes_per_dev` (`launch/dryrun.py`): each leaf's
    bytes over the parts its spec cuts it into, summed over the tree's
    leaves (a ClusteredTensor's fields each), in the reference's leaf
    order."""
    from repro_torch.tree import leaves
    total = 0
    for x, sh in zip(leaves(tree), leaves(shardings)):
        n = math.prod(x.shape) * x.element_size()
        total += n // max(spec_parts(getattr(sh, "spec", ()), mesh_shape), 1)
    return total


def compute_specs(model, mesh_shape: Dict[str, int]) -> Dict[tuple, tuple]:
    """{param path: its spec in the compute layout}: the projections cut by
    their output columns, the vocab tables whole (`distributed/layout.py
    serving_names` under SERVE_RULES)."""
    from repro_torch.distributed.layout import SERVE_RULES, serving_names
    from repro_torch.distributed.sharding import tree_shardings, use_rules
    with use_rules(_Shape(mesh_shape), SERVE_RULES, fsdp=False):
        return {p: sh.spec for p, sh in dict_leaves(tree_shardings(model.abstract(),
                                                              serving_names(model)))}


def cut_dim(spec, axis: str = "model") -> Optional[int]:
    """The dim a spec cuts over `axis`, or None."""
    for i, entry in enumerate(spec or ()):
        if axis in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            return i
    return None


def dict_leaves(tree, prefix=()):
    """(path tuple, leaf) of a nested dict, in its order (a ClusteredTensor
    is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from dict_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


class _Shape:
    """A stand-in mesh: the placements read only `.shape`."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)


class _Mesh:
    """The busiest rank's view of a mesh: its model axis, its data axes and
    their links."""

    def __init__(self, mesh_shape: Dict[str, int]):
        self.shape = dict(mesh_shape)
        self.m = mesh_shape.get("model", 1)
        self.data_axes = tuple(a for a in ("pod", "data") if a in mesh_shape)
        self.bw_model = link_bw(mesh_shape, ("model",))
        self.bw_data = link_bw(mesh_shape, self.data_axes)


# ---------------------------------------------------------------------------
# the full-sequence forward, per rank
# ---------------------------------------------------------------------------

def _attn_mixers(cfg, s: int) -> list:
    """(params subtree, projections feeding it, runs, query rows, key rows a
    row, query heads, kv heads, width gathered after it, remat'd) of every
    attention the full-sequence forward runs."""
    q, he, kv = cfg.q_dim_eff, cfg.n_heads_eff, cfg.n_kv_heads
    if cfg.family == "hybrid":
        from repro_torch.models.zamba2 import n_sites
        return [(("shared", "attn"), ("wq", "wk", "wv"), n_sites(cfg), s, s, he, kv, q, False)]
    if cfg.family == "audio":
        e = cfg.enc_seq
        return [(("enc", "blocks", "attn"), ("wq", "wk", "wv"), cfg.n_enc_layers, e, e, he,
                 he, q, True),
                (("dec", "blocks", "self_attn"), ("wq", "wk", "wv"), cfg.n_layers, s, s, he,
                 he, q, True),
                (("dec", "blocks", "cross_attn"), ("wq", "wk", "wv"), cfg.n_layers, s, e, he,
                 he, q, True)]
    if cfg.family in ("rwkv", "linear_attn"):
        return []
    t = s + cfg.n_img_tokens
    return [(("blocks", "attn"), ("wq", "wk", "wv"), cfg.n_layers, t, t, he, kv, q, True)]


def _scan_mixers(cfg) -> list:
    """(params subtree, projections feeding it, runs, heads, head dim, state
    dim, width gathered after it) of the chunked scans."""
    d = cfg.d_model
    if cfg.family == "rwkv":
        return [(("blocks", "tm"), ("wr", "wk", "wv"), cfg.n_layers, cfg.rwkv_heads,
                 cfg.rwkv_head_dim, cfg.rwkv_head_dim, d)]
    if cfg.family == "linear_attn":
        return [(("blocks", "attn"), ("wq", "wk", "wv"), cfg.n_layers, cfg.rwkv_heads,
                 cfg.rwkv_head_dim, cfg.rwkv_head_dim, d)]
    if cfg.family == "hybrid":
        return [((), (), cfg.n_layers, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                 cfg.d_inner)]
    return []


def forward_cost(model, mesh_shape: Dict[str, int], rows: int, seq: int,
                 rows_all: int, *, grad: bool) -> Dict[str, Cost]:
    """One full-sequence forward of `rows` rows of `seq` positions on the
    busiest rank of `mesh_shape`, by part:

      "layers"  the layer bodies a remat recomputes (products, mixers,
                elementwise), "proj" the projections' part of it;
      "rest"    the embedding, the head, the loss (with `grad`) and
                zamba2's shared block (not checkpointed);
      "chunks"  attention's chunk bodies a long sequence recomputes once
                more under grad;
      "gather"  the forward's collectives over the model axis and an MoE
                layer's over the data axes;
      "dx"      the backward's: each column-cut product's input gradient
                summed over the model axis, the MoE gathers reversed.

    `rows_all` is the rows of every data rank (an MoE layer routes them
    as one set)."""
    from repro_torch.models.layers import moe_capacity, moe_groups
    from repro_torch.models.zamba2 import n_sites
    cfg = model.cfg
    mesh = _Mesh(mesh_shape)
    m = mesh.m
    elt = cfg.torch_dtype.itemsize
    mdt = "f32" if cfg.torch_dtype == torch.float32 else "bf16"
    aparams = model.abstract()
    layout = compute_specs(model, mesh_shape)
    names = dict(dict_leaves(model.names()))
    parts = {k: Cost() for k in ("layers", "proj", "rest", "chunks", "gather", "dx")}
    t_text = rows * (seq + cfg.n_img_tokens)
    t_enc = rows * cfg.enc_seq

    # the mixers running per model rank over their heads: their projections
    # feed them ungathered, and their output width is gathered after
    per_rank, ungathered = {}, set()
    mixers = [(w, pr, r, kv, wd, t_enc if w[0] == "enc" else t_text)
              for w, pr, r, _, _, _, kv, wd, _ in _attn_mixers(cfg, seq)]
    mixers += [(w, pr, r, h, wd, t_text) for w, pr, r, h, _, _, wd in _scan_mixers(cfg)]
    for where, projs, runs, heads, width, tok in mixers:
        per_rank[where] = m > 1 and heads % m == 0
        if per_rank[where]:
            ungathered.update(where + (pj,) for pj in projs)
            parts["gather"].collective("all-gather", tok * width * elt, m, mesh.bw_model, runs)

    # the projections
    for path, leaf in dict_leaves(aparams):
        nm = names[path].split(",")
        if "vocab" in nm or path[-1] in ("pos_embed", "router") or "experts" in nm:
            continue
        matrix = [n for n in nm if n not in ("layers", "experts")]
        stack = math.prod(leaf.shape[:-2]) if len(matrix) == 2 else 1
        part = parts["rest"] if path[0] == "shared" else parts["layers"]
        uses = n_sites(cfg) if path[0] == "shared" else 1
        if len(matrix) != 2:                     # norms, biases, decays: read once
            part.hbm_bytes += uses * leaf.numel() * leaf.element_size()
            continue
        k, n = leaf.shape[-2:]
        cut = cut_dim(layout[path])
        n_rank = n // m if cut == leaf.ndim - 1 and m > 1 else n
        tok = t_enc if (path[0] == "enc" or (path[-2] == "cross_attn" and path[-1] in
                                              ("wk", "wv"))) else t_text
        dt = "f32" if leaf.dtype == torch.float32 else mdt
        c = Cost()
        c.ops(2.0 * uses * stack * tok * k * n_rank, dt)
        c.hbm_bytes += uses * stack * (k * n_rank * leaf.element_size() + tok * (k + n_rank) * elt)
        part += c
        if part is parts["layers"]:
            parts["proj"] += c
        if n_rank < n:
            if path not in ungathered:
                parts["gather"].collective("all-gather", tok * n * elt, m, mesh.bw_model,
                                           uses * stack)
            parts["dx"].collective("all-reduce", tok * k * elt, m, mesh.bw_model, uses * stack)

    # attention, as `_attn_chunk` computes it: every pair of each chunk
    for where, projs, runs, sq, sk, he, kv, width, remat in _attn_mixers(cfg, seq):
        h = he // m if per_rank[where] else he
        kv_r = kv // m if per_rank[where] else kv
        d = cfg.hd
        pairs = runs * rows * h * sq * sk
        c = Cost()
        c.ops(4.0 * pairs * d, "f32")
        c.s2_bytes = pairs * ATTN_PAIR_BYTES
        c.hbm_bytes = c.s2_bytes + runs * rows * (sq * h + 2 * sk * kv_r) * d * (4 + elt)
        if remat:
            parts["layers"] += c
        else:
            parts["rest"] += c
        if grad and sq > ATTN_CHUNK:
            parts["chunks"] += c

    # the chunked scans (f32)
    for where, projs, runs, heads, p, n, width in _scan_mixers(cfg):
        h = heads // m if per_rank[where] else heads
        q = min(SCAN_CHUNKS[cfg.family], seq)
        c = Cost()
        if cfg.family == "hybrid":
            di = cfg.d_inner // m if per_rank[where] else cfg.d_inner
            ops = 2 * q * n + h * (2 * q * p + 4 * p * n) + 2 * cfg.ssm_conv * di
        else:
            ops = h * (4 * q * p + 4 * p * p)
        c.ops(runs * t_text * ops, "f32")
        c.hbm_bytes += runs * t_text * (8 * h * p + 3 * h * q) * 4
        parts["layers"] += c

    # an MoE layer: the routing, dispatch and combine of a rank's groups
    # (each data rank's rows hold whole routing groups at the production
    # shapes; where they do not, the rows are gathered over the data axes
    # and every group routed on every rank), each rank's experts over its
    # groups' places, their outputs gathered over the model axis
    if cfg.n_experts:
        e, f, d, lay = cfg.n_experts, cfg.d_ff, cfg.d_model, cfg.n_layers
        per_row = seq + cfg.n_img_tokens
        n_d = rows_all // max(rows, 1)
        g, sg = moe_groups(rows_all * per_row)
        cap = moe_capacity(sg, cfg.moe_topk, e)
        own = n_d == 1 or (g % n_d == 0 and (rows * per_row) % sg == 0)
        g_r = g // n_d if own else g
        w_up = aparams["blocks"]["mlp"]["w_up"]
        e_r = e // m if cut_dim(layout[("blocks", "mlp", "w_up")]) == 1 else e
        c = Cost()
        c.ops(lay * (2.0 * g_r * sg * d * e + 4.0 * g_r * sg * e * cap * d), "f32")
        c.ops(lay * 3 * 2.0 * e_r * g_r * cap * d * f, mdt)
        c.hbm_bytes += lay * (3 * e_r * d * f * w_up.element_size()
                              + g_r * sg * e * cap * 4 * 4 + 4 * e_r * g_r * cap * (d + f) * elt)
        parts["layers"] += c
        parts["proj"] += c
        for part, kind in (("gather", "all-gather"), ("dx", "reduce-scatter")):
            if not own:
                parts[part].collective(kind, g * sg * d * elt, n_d, mesh.bw_data, 2 * lay)
            if e_r < e:
                parts[part].collective(kind, e * g_r * cap * d * elt, m, mesh.bw_model, lay)

    # elementwise: norms, residuals, RoPE and the MLP's activation, a few
    # passes over each layer's rows
    lay_rows = (cfg.n_layers * t_text + cfg.n_enc_layers * t_enc)
    parts["layers"].hbm_bytes += lay_rows * (12 * cfg.d_model + 5 * cfg.d_ff // max(m, 1)) * elt

    # the embedding rows, the head (the vocab tables whole on every rank)
    # and the loss's f32 passes over the logits
    v, d = cfg.padded_vocab, cfg.d_model
    head = parts["rest"]
    head.hbm_bytes += t_text * d * elt * 2
    head.ops(2.0 * t_text * d * v, mdt)
    head.hbm_bytes += d * v * elt + t_text * (d + v) * elt
    if cfg.final_softcap:
        head.hbm_bytes += t_text * v * (4 + elt) * 2
    if grad:
        head.ops(5.0 * t_text * v, "f32")
        head.hbm_bytes += t_text * v * 4 * 5
    return parts


# ---------------------------------------------------------------------------
# the three step kinds
# ---------------------------------------------------------------------------

def data_ranks(mesh_shape: Dict[str, int], n_rows: int) -> int:
    """The data ranks holding distinct rows of `n_rows` (`launch/steps.py
    train_rows`: the "batch" rule's cut, 1 where it leaves the batch
    whole)."""
    from repro_torch.launch.steps import train_rows
    return len(train_rows(_Shape(mesh_shape), n_rows))


def fsdp_cost(model, bundle, mesh_shape: Dict[str, int], n_d: int, *, grad: bool) -> Cost:
    """The params' collectives: each leaf gathered from its stored placement
    (the bundle's `in_shardings[0]`) to the compute layout (all-gather over
    the data axes of an FSDP cut; over the model axis, an all-gather where
    the compute layout keeps the leaf whole, an all-to-all where it cuts
    another dim), and with `grad` the gradients back: a reduce-scatter over
    the data axes of an FSDP-cut leaf, else an all-reduce over the data
    ranks, the model-axis step reversed, and the global norm's all-reduce."""
    mesh = _Mesh(mesh_shape)
    m = mesh.m
    compute = compute_specs(model, mesh_shape)
    stored = dict(dict_leaves(bundle.in_shardings[0]))
    c = Cost()
    for path, leaf in dict_leaves(bundle.abstract_inputs[0]):
        w = leaf.numel() * leaf.element_size()
        s_spec, c_spec = stored[path].spec, compute[path]
        m_cut, c_cut = cut_dim(s_spec), cut_dim(c_spec)
        d_parts = spec_parts(s_spec, {a: mesh.shape[a] for a in mesh.data_axes})
        m_store = m if m_cut is not None else 1
        c_parts = m if c_cut is not None else 1
        c.collective("all-gather", w / m_store, d_parts, mesh.bw_data)
        # the compute layout's copy beyond the stored part, written once
        c.hbm_bytes += max(w / c_parts - w / (m_store * d_parts), 0.0)
        if m_store > 1 and c_cut != m_cut:
            if c_cut is None:
                c.collective("all-gather", w, m, mesh.bw_model)
            else:
                c.collective("all-to-all", w / m, m, mesh.bw_model)
        if not grad:
            continue
        if d_parts > 1:
            c.collective("reduce-scatter", w / c_parts, n_d, mesh.bw_data)
        else:
            c.collective("all-reduce", w / c_parts, n_d, mesh.bw_data)
        if m_store > 1 and c_cut != m_cut:
            c.collective("reduce-scatter" if c_cut is None else "all-to-all",
                         w if c_cut is None else w / m, m, mesh.bw_model)
    if grad:
        c.collective("all-reduce", 4, math.prod(mesh_shape.values()), mesh.bw_data)
    return c


def train_cost(model, bundle, shape, mesh_shape: Dict[str, int], *, microbatch: int = 0,
               grad_compress: bool = False) -> Cost:
    """One train step (see the module docstring) on the busiest rank."""
    cfg = model.cfg
    n_d = data_ranks(mesh_shape, shape.global_batch)
    rows = shape.global_batch // n_d
    n_mb = microbatch if microbatch and microbatch > 1 else 1
    f = forward_cost(model, mesh_shape, rows, shape.seq_len, shape.global_batch, grad=True)
    remat = cfg.remat
    if not remat:
        again = Cost()
    elif cfg.remat_policy == "dots":                # the projections' outputs saved
        again = f["layers"] + Cost(hbm_bytes=-f["proj"].hbm_bytes,
                                   flops={k: -v for k, v in f["proj"].flops.items()})
    else:
        again = f["layers"]
    body = f["layers"] + f["rest"]
    step = body + again + f["chunks"] + body.scaled(2.0)
    step = step + f["gather"].scaled(2.0 if remat else 1.0) + f["dx"]
    if n_mb > 1:                                     # the same work in n_mb splits
        step.coll_counts = {k: v * n_mb for k, v in step.coll_counts.items()}
    step = step + fsdp_cost(model, bundle, mesh_shape, n_d, grad=True)
    # Adam (and the int8 error feedback) over the rank's parts
    stored = dict(dict_leaves(bundle.in_shardings[0]))
    elems = 0
    for path, leaf in dict_leaves(bundle.abstract_inputs[0]):
        elems_l = leaf.numel() / spec_parts(stored[path].spec, mesh_shape)
        elems += elems_l
        step.hbm_bytes += elems_l * (2 * leaf.element_size() + ADAM_BYTES
                                     + (12 if grad_compress else 0))
    step.ops(12.0 * elems, "f32")
    return step


def prefill_cost(model, bundle, shape, mesh_shape: Dict[str, int]) -> Cost:
    """The prefill step (the full-sequence forward under no_grad)."""
    n_d = data_ranks(mesh_shape, shape.global_batch)
    rows = shape.global_batch // n_d
    f = forward_cost(model, mesh_shape, rows, shape.seq_len, shape.global_batch, grad=False)
    return (f["layers"] + f["rest"] + f["gather"]
            + fsdp_cost(model, bundle, mesh_shape, n_d, grad=False))


def decode_ecfg(model, shape, *, kv_dtype: Optional[str] = None, block_size: int = 16):
    """The engine the decode roofline scores: `shape.global_batch` slots and
    a pool of `shape.seq_len` tokens a slot."""
    from repro_torch.launch.engine import EngineConfig
    nbw = -(-shape.seq_len // block_size)
    return EngineConfig(num_slots=shape.global_batch, block_size=block_size,
                        num_blocks=shape.global_batch * nbw, max_blocks_per_slot=nbw,
                        kv_dtype=kv_dtype)


def decode_cost(model, params, ecfg, mesh_shape: Dict[str, int]) -> Cost:
    """The engine's width-1 step: `score_layout`'s operations (at the f32
    rate: the decode kernels' arithmetic), bytes and gathers, and the float
    projections' products it leaves out (in the model dtype). Its gathers
    take the slowest link among the mesh's cut axes."""
    from repro_torch.core.api import is_clustered
    from repro_torch.distributed.layout import (SERVE_RULES, _uses, score_layout,
                                                serving_names)
    from repro_torch.distributed.sharding import auto_shard, logical_to_spec, use_rules
    cfg = model.cfg
    mesh = _Shape(mesh_shape)
    row = score_layout(model, params, ecfg, mesh)
    c = Cost(flops={"f32": row["flops"]}, hbm_bytes=row["bytes"],
             coll_bytes={"all-gather": row["coll_bytes"]} if row["coll_bytes"] else {},
             coll_counts={k: float(v) for k, v in row["coll_counts"].items()})
    cut = [a for a, n in mesh_shape.items() if n > 1]
    if row["coll_bytes"]:
        c.t_collective = row["coll_bytes"] / min(link_bw(mesh_shape, (a,)) for a in cut)
    m = mesh_shape.get("model", 1)
    mdt = "f32" if cfg.torch_dtype == torch.float32 else "bf16"
    with use_rules(mesh, SERVE_RULES, fsdp=False):
        shards = dict(dict_leaves(auto_shard(params, serving_names(model))))
        slots = ecfg.num_slots
        s_rank = slots // (spec_parts(logical_to_spec((slots,), ("slots",)), mesh_shape))
    names = dict(dict_leaves(model.names()))
    for path, leaf in dict_leaves(params):
        nm = names[path].split(",")
        if (is_clustered(leaf) or "vocab" in nm or "experts" in nm
                or path[-1] == "pos_embed" or not _uses(model, path)):
            continue
        if len([n for n in nm if n not in ("layers", "experts")]) != 2:
            continue
        k, n = leaf.shape[-2:]
        stack = math.prod(leaf.shape[:-2])
        n_rank = n // m if cut_dim(shards[path].spec) == leaf.ndim - 1 and m > 1 else n
        c.ops(2.0 * _uses(model, path) * stack * s_rank * k * n_rank, mdt)
    return c
