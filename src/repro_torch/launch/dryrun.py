"""The dry run: every (arch × shape) cell on the production meshes, on
"meta" tensors, with what a card holds and the step's roofline terms — the
port of the JAX package's `launch/dryrun.py`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # (16, 16)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multipod   # (2, 16, 16)
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --lcd        # packed codes

Nothing is allocated and no step runs: the mesh is `make_production_mesh`
over `[torch.device("meta")] * n`, and each cell builds its step bundle
(`launch/steps.py`: train_4k the train step, prefill_32k the prefill
forward, the decode shapes the serve step, `--lcd` over the
ClusteredTensor tree of `core/clustered_params.py clustered_abstract`)
under the reference's rules for the cell: FSDP off for decode, a hybrid
decode's `ssm_inner` / `ssm_heads` whole, `seq_kv` whole where the kv heads
fill the model axis and the batch fills the data axes. So it needs no
card, and it runs the same where there is one.

Per cell it writes `<out>/<cell>.json` (`<arch>__<shape>__pod1|pod2[__lcd]
[__kv8][__tag]`) with the reference's keys:

  * `memory`: `argument_size`, exactly the bundle's abstract inputs under
    their placements (the reference's `bytes_per_dev`); `output_size`, the
    step's new outputs (a decode step updates its cache in place and
    returns it, so only its tokens are new); `temp_size`, the analytic
    peak beyond the arguments (below); `total_per_chip`, their sum; and
    `hbm_ok`, whether it fits the card's 80 GB;
  * the roofline of `distributed/cost.py` (the analytic count of the step
    the port runs, on the busiest rank): `flops_per_dev` (and
    `flops_by_dtype`), `hbm_bytes_per_dev`, `coll_bytes_per_dev`,
    `collectives`, `collective_counts`, `t_compute`, `t_memory`,
    `t_collective`, `dominant`, `t_step`, `model_flops`,
    `useful_flop_frac`, `mfu`;
  * decode: `param_bytes_per_dev`, `cache_bytes_per_dev` and the
    reference's analytic `t_memory_analytic` = (params + 2 x cache) / HBM
    and `t_step_analytic`; the roofline itself is the engine's width-1
    step (`cost.decode_cost`) at the shape's batch as slots and a pool of
    its sequence a slot, whose inputs (params and pools under the serving
    placement, the step's int32 upload) and logits `engine` records;
  * train and prefill (not rwkv, as in the reference):
    `attn_s2_bytes_per_dev` and the `_flash` variants of `t_memory`,
    `t_step` and `mfu`, the step with the S x S score traffic taken out,
    as the flash kernel (B9) would run it.

`temp_size`, per rank (T the rank's tokens of a split, elt the model
dtype's bytes, ff / heads the rank's share):
  train    the compute layout's copy of the params beyond the stored part
           + their f32 gradients + the activations the remat policy saves
           (each layer's input; "dots" also its projections' outputs; none:
           every layer's working set) + twice the largest layer's working
           set (its q, k, v, output and MLP rows, one attention chunk's f32
           scores three times over, the scan's chunk) + the logits (elt +
           3 x 4 bytes a logit: themselves, the f32 copy, the mask, the
           gradient);
  prefill  the compute layout's copy beyond the stored part + one layer's
           working set + the logits of every position (elt a logit);
  decode   one layer's cached K and V upcast to f32 (`_attn_chunk`), its
           scores and the f32 logits.

Left out, as XLA's own: `lower_s`, `compile_s`,
`memory.generated_code_size`, and the LCD decode's `dequant_bytes_per_dev`,
`t_memory_kernel` and `t_step_kernel` (the reference's correction of XLA's
fallback, which materializes the dequantized weight; the port's decode
roofline streams the packed codes already).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import traceback
from typing import Dict

import torch

from repro_torch.distributed import cost as C
from repro_torch.utils import human_bytes, logger


def lcd_abstract(model, nbits: int = 4, *, calibrated: bool = False):
    """`clustered_abstract`'s tree as tensors on "meta": every eligible
    weight a ClusteredTensor of packed uint8 codes, an f32 codebook and
    smoothing vector; with `calibrated`, also the quantized Eq. 11
    transform's f32 `inv_scale` (d_in) and `act_scale` (one a stacked
    tensor), as a calibrated deployment serves them."""
    from repro_torch.core.api import ClusteredTensor, is_clustered
    from repro_torch.core.clustered_params import clustered_abstract
    shapes, _ = clustered_abstract(model, nbits=nbits)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def one(leaf):
        if isinstance(leaf, dict):
            return {k: one(v) for k, v in leaf.items()}
        if not is_clustered(leaf):
            return meta(*leaf)
        f32 = torch.float32
        extra = dict(inv_scale=meta(leaf.smooth, f32),
                     act_scale=meta(leaf.smooth[:-1], f32)) if calibrated else {}
        return ClusteredTensor(meta(leaf.codes, torch.uint8), meta(leaf.codebook, f32),
                               meta(leaf.smooth, f32), nbits=leaf.nbits, **extra)
    return one(shapes)


def _compute_bytes(model, bundle, mesh_shape):
    """(bytes a rank holds of the compute layout's params beyond its stored
    part (the FSDP gather's copies), the f32 bytes of its gradients)."""
    compute = C.compute_specs(model, mesh_shape)
    stored = dict(C.dict_leaves(bundle.in_shardings[0]))
    extra = grads = 0
    for path, leaf in C.dict_leaves(bundle.abstract_inputs[0]):
        w = leaf.numel() * leaf.element_size()
        parts = C.spec_parts(compute[path], mesh_shape)
        extra += max(w // parts - w // C.spec_parts(stored[path].spec, mesh_shape), 0)
        grads += leaf.numel() * 4 // parts
    return extra, grads


def _layer_working_set(cfg, mesh_shape, rows: int, seq: int) -> float:
    """Bytes of one layer's activations on a rank (see the module
    docstring)."""
    m = mesh_shape.get("model", 1)
    elt = cfg.torch_dtype.itemsize
    t = rows * (seq + cfg.n_img_tokens)
    heads = cfg.n_heads_eff // m if cfg.n_kv_heads % m == 0 else cfg.n_heads_eff
    rows_attn = 0 if cfg.family in ("rwkv", "linear_attn") else (
        rows * heads * min(seq, C.ATTN_CHUNK) * seq * 4 * 3)
    proj = t * (2 * cfg.q_dim_eff + 2 * cfg.kv_dim + 3 * cfg.d_model) * elt
    mlp = t * 3 * (cfg.d_ff // m if cfg.d_ff % m == 0 else cfg.d_ff) * elt
    if cfg.family in C.SCAN_CHUNKS:
        q = C.SCAN_CHUNKS[cfg.family]
        proj += t * (cfg.d_inner if cfg.family == "hybrid" else cfg.d_model) * 4 * 4
        rows_attn = max(rows_attn, t * q * 4 * 3)
    return proj + mlp + rows_attn


def _memory(kind, model, bundle, shape, mesh_shape, *, microbatch: int) -> Dict[str, int]:
    """The cell's `memory` record, per rank (the module docstring's
    formulas)."""
    cfg = model.cfg
    leaves_in = bundle.abstract_inputs
    arg = C.bytes_per_rank(leaves_in, bundle.in_shardings, mesh_shape)
    elt = cfg.torch_dtype.itemsize
    v = cfg.padded_vocab
    n_d = C.data_ranks(mesh_shape, shape.global_batch)
    rows = shape.global_batch // n_d
    if kind == "train":
        out = C.bytes_per_rank(leaves_in[:3], bundle.out_shardings[:3], mesh_shape) + 3 * 4
        n_mb = microbatch if microbatch and microbatch > 1 else 1
        r = max(rows // n_mb, 1)
        t = r * (shape.seq_len + cfg.n_img_tokens)
        gathered, grads = _compute_bytes(model, bundle, mesh_shape)
        ws = _layer_working_set(cfg, mesh_shape, r, shape.seq_len)
        lay = cfg.n_layers + cfg.n_enc_layers
        if not cfg.remat:
            saved = lay * ws
        else:
            saved = lay * t * cfg.d_model * elt
            if cfg.remat_policy == "dots":
                saved += lay * t * (2 * cfg.q_dim_eff + 2 * cfg.kv_dim + 2 * cfg.d_ff) * elt
        temp = gathered + grads + saved + 2 * ws + t * v * (elt + 3 * 4)
    elif kind == "prefill":
        out = C.bytes_per_rank([torch.empty((shape.global_batch, v), dtype=cfg.torch_dtype,
                                            device="meta")], [bundle.out_shardings], mesh_shape)
        t = rows * (shape.seq_len + cfg.n_img_tokens)
        temp = (_compute_bytes(model, bundle, mesh_shape)[0]
                + _layer_working_set(cfg, mesh_shape, rows, shape.seq_len) + t * v * elt)
    else:
        tok_sh = bundle.out_shardings[0]
        out = C.bytes_per_rank([torch.empty((shape.global_batch,), dtype=torch.int32,
                                            device="meta")], [tok_sh], mesh_shape)
        cache, cache_sh = leaves_in[1], bundle.in_shardings[1]
        temp = rows * v * 4
        if "k" in cache:                 # one layer's K and V in f32, its scores
            k = cache["k"]
            keys = k.numel() // k.shape[0] // k.shape[-1] // C.spec_parts(
                cache_sh["k"].spec, mesh_shape)
            group = max(cfg.n_heads_eff // max(k.shape[-2], 1), 1)
            temp += 2 * keys * k.shape[-1] * 4 + keys * group * 4 * 3
    mem = {"argument_size": int(arg), "output_size": int(out), "temp_size": int(temp)}
    mem["total_per_chip"] = sum(mem.values())
    return mem


def cell_bundle(model, shape, mesh, *, lcd: bool = False, params=None,
                microbatch: int = 0, grad_compress: bool = False, fsdp: bool = True):
    """(the cell's step bundle, its model FLOPs): built under the reference's
    rules for the cell (FSDP off for decode; a hybrid decode's `ssm_inner` /
    `ssm_heads` whole; `seq_kv` whole where 16 divides the kv heads and the
    batch is at least 32) on `mesh` (any object with a `.shape` {axis:
    size}). `params` replaces a decode step's abstract parameter tree
    (default: the model's, or `lcd_abstract`'s with `lcd`)."""
    from repro_torch.core.clustered_params import clustered_names
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                          build_train_step)
    cfg = model.cfg
    use_fsdp = fsdp and shape.kind != "decode"
    overrides = {}
    if shape.kind == "decode" and cfg.family == "hybrid":
        overrides.update(ssm_inner=None, ssm_heads=None)
    if (shape.kind == "decode" and cfg.n_kv_heads % 16 == 0
            and shape.global_batch >= 32):
        overrides["seq_kv"] = None
    n_active = cfg.param_count(active_only=True)
    with use_rules(mesh, overrides, fsdp=use_fsdp):
        if shape.kind == "train":
            return (build_train_step(model, shape, microbatch=microbatch,
                                     grad_compress=grad_compress),
                    C.model_flops_train(n_active, shape.global_batch * shape.seq_len))
        if shape.kind == "prefill":
            return (build_prefill_step(model, shape),
                    C.model_flops_decode(n_active, shape.global_batch * shape.seq_len))
        if params is None and lcd:
            params = lcd_abstract(model)
        return (build_serve_step(model, shape, clustered_params=params,
                                 clustered_names=None if params is None
                                 else clustered_names(model)),
                C.model_flops_decode(n_active, shape.global_batch))


def analyze_cell(model, shape, mesh, *, lcd: bool = False, params=None,
                 microbatch: int = 0, grad_compress: bool = False, fsdp: bool = True,
                 ecfg=None) -> dict:
    """The dry run of one step of `model` at `shape` on `mesh`: the bundle
    of `cell_bundle`, its memory and its roofline, as `run_cell` reports
    them (without the cell's name and status). `ecfg` is the engine the
    decode roofline scores (default: `cost.decode_ecfg`)."""
    from repro_torch.distributed.layout import SERVE_RULES, cache_shardings, serving_names
    from repro_torch.distributed.sharding import auto_shard, use_rules
    cfg = model.cfg
    mesh_shape = dict(mesh.shape)
    chips = math.prod(mesh_shape.values())
    bundle, mflops = cell_bundle(model, shape, mesh, lcd=lcd, params=params,
                                 microbatch=microbatch, grad_compress=grad_compress,
                                 fsdp=fsdp)
    result: Dict = {}
    if shape.kind == "train":
        cost = C.train_cost(model, bundle, shape, mesh_shape, microbatch=microbatch,
                            grad_compress=grad_compress)
    elif shape.kind == "prefill":
        cost = C.prefill_cost(model, bundle, shape, mesh_shape)
    else:
        ecfg = ecfg or C.decode_ecfg(
            model, shape, kv_dtype="int8" if cfg.kv_cache_dtype == "int8" else None)
        aparams = bundle.abstract_inputs[0]
        cost = C.decode_cost(model, aparams, ecfg, mesh_shape)
        # the engine's own inputs: params and pools under the serving
        # placement, and the step's int32 upload
        caches = model.init_seq_caches(
            num_blocks=ecfg.num_blocks, block_size=ecfg.block_size,
            num_slots=ecfg.num_slots, max_seq=ecfg.max_seq,
            kv_dtype=ecfg.kv_dtype if "paged" in model.seq_caches else None, device="meta")
        with use_rules(mesh, SERVE_RULES, fsdp=False):
            p_sh = auto_shard(aparams, serving_names(model))
            c_sh = cache_shardings(model, caches)
        upload = 4 * ecfg.num_slots * (1 + 2 + ecfg.max_blocks_per_slot)
        e_params = C.bytes_per_rank(aparams, p_sh, mesh_shape)
        e_pools = C.bytes_per_rank(caches, c_sh, mesh_shape)
        # beyond them, the step's logits and their f32 greedy read
        e_temp = ecfg.num_slots * cfg.padded_vocab * (cfg.torch_dtype.itemsize + 4)
        result["engine"] = dict(
            num_slots=ecfg.num_slots, block_size=ecfg.block_size,
            num_blocks=ecfg.num_blocks, max_blocks_per_slot=ecfg.max_blocks_per_slot,
            param_bytes_per_dev=e_params, pool_bytes_per_dev=e_pools, upload_bytes=upload,
            argument_size=e_params + e_pools + upload, temp_size=e_temp,
            total_per_chip=e_params + e_pools + upload + e_temp)
    roof = C.roofline(cost, chips, mflops)
    mem = _memory(shape.kind, model, bundle, shape, mesh_shape, microbatch=microbatch)
    result.update(
        memory=mem, hbm_ok=bool(mem["total_per_chip"] < C.HBM_BYTES), card=C.CARD,
        flops_per_dev=roof.flops, flops_by_dtype=dict(cost.flops),
        hbm_bytes_per_dev=roof.hbm_bytes, coll_bytes_per_dev=roof.coll_bytes,
        collectives=roof.collectives.bytes_by_kind,
        collective_counts=roof.collectives.count_by_kind,
        t_compute=roof.t_compute, t_memory=roof.t_memory,
        t_collective=roof.t_collective, dominant=roof.dominant,
        t_step=roof.t_step, model_flops=mflops,
        useful_flop_frac=roof.useful_flop_frac, mfu=roof.mfu)
    if shape.kind == "decode":
        p_bytes = C.bytes_per_rank(bundle.abstract_inputs[0], bundle.in_shardings[0],
                                   mesh_shape)
        c_bytes = C.bytes_per_rank(bundle.abstract_inputs[1], bundle.in_shardings[1],
                                   mesh_shape)
        t_mem = (p_bytes + 2 * c_bytes) / C.HBM_BW
        result.update(param_bytes_per_dev=p_bytes, cache_bytes_per_dev=c_bytes,
                      t_memory_analytic=t_mem,
                      t_step_analytic=max(roof.t_compute, t_mem, roof.t_collective))
    elif cfg.family != "rwkv":
        flash = C.roofline(cost, chips, mflops, without_s2=True)
        result.update(attn_s2_bytes_per_dev=cost.s2_bytes, t_memory_flash=flash.t_memory,
                      t_step_flash=flash.t_step, mfu_flash=flash.mfu)
    return result


def cell_name(arch: str, shape_name: str, *, multi_pod: bool = False, lcd: bool = False,
              kv8: bool = False, tag: str = "") -> str:
    return (f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
            + ("__lcd" if lcd else "") + ("__kv8" if kv8 else "") + (f"__{tag}" if tag else ""))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             lcd: bool = False, kv8: bool = False, microbatch: int = 0,
             grad_compress: bool = False, remat_policy: str = "nothing",
             out_dir: str = "experiments/dryrun", fsdp: bool = True, save: bool = True,
             tag: str = "") -> dict:
    """One cell of the matrix on `make_production_mesh` over "meta" devices:
    "skipped" with the reason where the shape does not apply to the arch,
    else "ok" with `analyze_cell`'s result; saved as `<out_dir>/<cell>.json`
    with `save`."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import SHAPES, get_config, shape_applicable
    from repro_torch.models.registry import get_model
    cfg = get_config(arch)
    if kv8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if remat_policy != "nothing":
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    cell = cell_name(arch, shape_name, multi_pod=multi_pod, lcd=lcd, kv8=kv8, tag=tag)
    if not ok:
        return {"cell": cell, "status": "skipped", "reason": why}
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=[torch.device("meta")] * (512 if multi_pod else 256))
    model = get_model(cfg)
    result = {"cell": cell, "arch": arch, "shape": shape_name, "mesh": dict(mesh.shape),
              "chips": mesh.size, "variant": "lcd" if lcd else "bf16", "status": "?"}
    result.update(analyze_cell(model, shape, mesh, lcd=lcd, microbatch=microbatch,
                               grad_compress=grad_compress, fsdp=fsdp))
    result["status"] = "ok"
    logger.info(
        f"{cell}: per-chip {human_bytes(result['memory']['total_per_chip'])} | "
        f"t_c={result['t_compute']*1e3:.2f}ms t_m={result['t_memory']*1e3:.2f}ms "
        f"t_x={result['t_collective']*1e3:.2f}ms -> {result['dominant']} | "
        f"MFU={result['mfu']:.1%}")
    if save:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, cell + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def run_all(multi_pod: bool = False, lcd: bool = False, out_dir: str = "experiments/dryrun",
            *, archs=None, shapes=None, **cell_kw) -> list:
    """`run_cell` over every arch x shape, the `--all` matrix by default
    (every arch but llama2-7b, every shape): the cells' results, a cell that
    raises reported with status "error" and the exception as its reason (its
    traceback printed) instead of ending the loop. `cell_kw` goes to every
    `run_cell`."""
    from repro_torch.models.config import SHAPES, list_archs
    # llama2-7b is the paper's subject, not an assigned cell: the matrix
    # keeps to the other archs unless it is named
    archs = archs or [a for a in list_archs() if a != "llama2-7b"]
    cells = []
    for a in archs:
        for s in shapes or list(SHAPES):
            try:
                cells.append(run_cell(a, s, multi_pod=multi_pod, lcd=lcd, out_dir=out_dir,
                                      **cell_kw))
            except Exception as e:
                traceback.print_exc()
                name = cell_name(a, s, multi_pod=multi_pod, lcd=lcd,
                                 kv8=cell_kw.get("kv8", False), tag=cell_kw.get("tag", ""))
                cells.append({"cell": name, "status": "error",
                              "reason": f"{type(e).__name__}: {e}"[:2000]})
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[None, "train_4k", "prefill_32k",
                                                     "decode_32k", "long_500k"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--lcd", action="store_true")
    ap.add_argument("--kv8", action="store_true")
    ap.add_argument("--remat-policy", default="nothing")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    from repro_torch.models.config import list_archs

    cells = run_all(args.multipod, args.lcd, args.out,
                    archs=None if args.all else [args.arch] if args.arch else list_archs(),
                    shapes=None if args.all or not args.shape else [args.shape],
                    kv8=args.kv8, remat_policy=args.remat_policy,
                    microbatch=args.microbatch, grad_compress=args.grad_compress,
                    fsdp=not args.no_fsdp, tag=args.tag)
    print(json.dumps([{k: c.get(k) for k in ("cell", "status", "dominant", "t_step", "mfu")}
                      for c in cells], indent=1))
    return 1 if any(c["status"] not in ("ok", "skipped") for c in cells) else 0


if __name__ == "__main__":
    sys.exit(main())
