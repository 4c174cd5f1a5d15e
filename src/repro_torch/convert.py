"""Carry weights and cache state across from the JAX package.

`from_reference` takes the reference's trees in a framework-neutral form —
nested dicts of **numpy arrays**, a ClusteredTensor as a dict of its six array
fields (`None`s kept) plus `nbits` — and returns this package's parameters or
serving caches on a device. Flattening a live JAX pytree to that form is the
caller's business (the tests keep a helper for it); nothing here imports JAX.
bfloat16 leaves cross as float32 numpy arrays and are cast back with `dtype`.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.api import CT_ARRAY_FIELDS, ClusteredTensor
from repro_torch.utils import resolve_device


def _is_clustered_dict(node: Any) -> bool:
    return isinstance(node, dict) and "nbits" in node and "codebook" in node


def _tensor(a: np.ndarray, device, float_dtype: Optional[torch.dtype]):
    t = torch.tensor(np.asarray(a))      # a copy: the pools are written in place
    if float_dtype is not None and t.is_floating_point():
        t = t.to(float_dtype)
    return t.to(device)


def _clustered(node: dict, device) -> ClusteredTensor:
    fields = {}
    for f in CT_ARRAY_FIELDS:
        a = node.get(f)
        if a is None:
            fields[f] = None
            continue
        a = np.asarray(a)
        if f == "packed" or (f == "codes" and a.dtype == np.uint8):
            a = a.astype(np.uint8)
        elif f == "codes":
            a = a.astype(np.int8)
        else:
            a = a.astype(np.float32)
        fields[f] = _tensor(a, device, None)
    return ClusteredTensor(nbits=int(node["nbits"]), **fields)


def from_reference(tree: Any, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> Any:
    """The port's parameters (or serving caches: paged pools, slot state) from
    the reference's tree of numpy arrays, on `device`.

    Dense floating leaves are cast to `dtype` when given (pass the model
    dtype to turn float32-carried bfloat16 weights back); the leaves that
    are float32 in every model dtype (`_F32_LEAVES`: norm scales, cache
    scale pools and smoothing vectors, the recurrent families' dynamics
    parameters and f32 state, the mamba conv weight) — and every field of a
    ClusteredTensor — keep the dtype they arrive in.
    Integer leaves (int8 KV codes) always keep theirs."""
    dev = resolve_device(device)

    def walk(node, path=()):
        if _is_clustered_dict(node):
            return _clustered(node, dev)
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if node is None:
            return None
        a = np.asarray(node)
        # the mamba conv weight is f32, the mamba conv state the model dtype
        name = path[-1] if path else ""
        keep_f32 = name in _F32_LEAVES or path[-2:] == ("blocks", "conv")
        return _tensor(a, dev, None if keep_f32 else dtype)

    return walk(tree)


# leaves that are float32 whatever the model dtype: norm scales and biases,
# the int8 pools' scales and smoothing vectors, the recurrent families'
# dynamics parameters (decay / gate LoRA, u bonus, SSM A, dt bias, D skip)
# and their f32 state (rwkv6 "wkv", gla "s", zamba2 "ssm")
_F32_LEAVES = frozenset({
    "scale", "bias", "k_scale", "v_scale", "k_smooth", "v_smooth",
    "w0", "decay_A", "decay_B", "u", "g0", "gate_A", "gate_B", "a_log", "dt_bias",
    "d_skip", "wkv", "s", "ssm"})
