"""Declarative parameter tables.

A model declares its parameters once as a nested dict of
    name -> ParamDecl(shape, logical_names, init)
and every view comes from that one table, each a nested dict with its keys:
  * `init_params`     — materialized tensors;
  * `abstract_params` — tensors on the "meta" device (the dry run's
                        inputs: shapes and dtypes, no storage);
  * `names_tree`      — comma-joined logical-name strings (sharding specs).
The logical names are kept from the JAX package (they also drive the
clustering eligibility rule in core/clustered_params.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    names: str                   # comma-joined logical dims, e.g. "layers,embed,ff"
    init: str = "normal"         # normal[:std] | zeros | ones | embed | fanin[:g] | uniform:lo~hi
    dtype: Optional[str] = None  # override model dtype (e.g. float32 for norms)


Table = Dict[str, Union[ParamDecl, "Table"]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def iter_table(table: Table, prefix: str = "") -> Iterator[Tuple[str, ParamDecl]]:
    """(path, decl) pairs in declaration order; a path reads "['a']['b']"."""
    for name, v in table.items():
        path = f"{prefix}['{name}']"
        if isinstance(v, ParamDecl):
            yield path, v
        else:
            yield from iter_table(v, path)


def map_table(table: Table, fn, prefix: str = "") -> Dict[str, Any]:
    """Nested dict with `fn(path, decl)` at every declaration."""
    out: Dict[str, Any] = {}
    for name, v in table.items():
        path = f"{prefix}['{name}']"
        out[name] = fn(path, v) if isinstance(v, ParamDecl) else map_table(v, fn, path)
    return out


def decl_dtype(d: ParamDecl, default_dtype: torch.dtype) -> torch.dtype:
    return _DTYPES[d.dtype] if d.dtype else default_dtype


def _init_one(gen: torch.Generator, d: ParamDecl, default_dtype, device) -> torch.Tensor:
    dtype = decl_dtype(d, default_dtype)
    kind, _, arg = d.init.partition(":")
    if kind == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)

    def normal(std: float) -> torch.Tensor:
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (x * std).to(dtype).to(device)

    if kind == "normal":
        return normal(float(arg) if arg else 0.02)
    if kind == "embed":
        return normal(0.01)
    if kind == "fanin":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return normal((float(arg) if arg else 1.0) / math.sqrt(fan_in))
    if kind == "uniform":                  # e.g. the recurrent families' decays
        lo, hi = (float(v) for v in arg.split("~"))
        x = torch.rand(d.shape, generator=gen, dtype=torch.float32, device=gen.device)
        return (lo + (hi - lo) * x).to(dtype).to(device)
    raise ValueError(f"unknown init {d.init!r}")


def init_params(generator: torch.Generator, table: Table, dtype: torch.dtype,
                device="cuda") -> Dict[str, Any]:
    """Materialize `table` from an explicit generator. Random numbers are
    drawn on the generator's device and moved to `device`."""
    device = resolve_device(device)
    return map_table(
        table, lambda _path, d: _init_one(generator, d, dtype, device))


def abstract_params(table: Table, dtype: torch.dtype) -> Dict[str, Any]:
    """The table as tensors on the "meta" device: declared shapes and dtypes,
    nothing allocated (the JAX package's ShapeDtypeStruct tree)."""
    return map_table(table, lambda _path, d: torch.empty(
        d.shape, dtype=decl_dtype(d, dtype), device="meta"))


def names_tree(table: Table) -> Dict[str, Any]:
    """The table's comma-joined logical dim names, one string a parameter."""
    return map_table(table, lambda _path, d: d.names)


def param_count(table: Table) -> int:
    return int(sum(math.prod(d.shape) for _, d in iter_table(table)))
