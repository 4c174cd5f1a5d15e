"""Cross-framework test helper: the JAX package `repro` (the reference) and
its PyTorch port `repro_torch` fed the same numpy inputs.

  * `to_numpy_tree`   — a live JAX pytree (params, paged cache) -> nested dicts
                        of numpy arrays, a ClusteredTensor as a dict of its six
                        array fields plus `nbits`: the framework-neutral form
                        `repro_torch.convert.from_reference` takes;
  * `both`            — call a `repro.*` function and its `repro_torch.*` twin
                        on the same numpy arrays, results back as numpy;
  * `assert_close`    — one comparison that prints the stated tolerance;
  * `with_act_scale`  — arm the quantized transform on a port ClusteredTensor;
  * `cluster_params`  — a fast, deterministic stand-in for `compress_model`
                        (quantile clustering through the reference's own
                        ClusteredTensor layout) so whole-model tests get LCD
                        weights in milliseconds;
  * `one_torch_thread` — a fixture for tests that run the compression
                        pipeline on the CPU.

Only tests import this module: it imports both frameworks.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import ClusteredTensor as RefClusteredTensor
from repro.core.lut import pack_codes as ref_pack_codes

CT_FIELDS = ("codes", "codebook", "smooth", "packed", "inv_scale", "act_scale")

CLUSTERED_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def np_of(a) -> Optional[np.ndarray]:
    """numpy view of a JAX array or torch tensor (bf16 crosses as float32)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def to_numpy_tree(tree: Any) -> Any:
    """JAX pytree -> nested dicts of numpy arrays (see the module docstring)."""
    if isinstance(tree, RefClusteredTensor):
        out = {f: np_of(getattr(tree, f)) for f in CT_FIELDS}
        out["nbits"] = int(tree.nbits)
        return out
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np_of(tree)


def both(ref_fn, port_fn, *arrays, ref_kwargs=None, port_kwargs=None):
    """(reference result, port result) of the same numpy `arrays`, as numpy.
    Tuples of results come back as tuples."""
    def out(r):
        return tuple(np_of(x) for x in r) if isinstance(r, (tuple, list)) else np_of(r)

    r = ref_fn(*[jnp.asarray(a) for a in arrays], **(ref_kwargs or {}))
    p = port_fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays],
                **(port_kwargs or {}))
    return out(r), out(p)


def assert_close(got, want, *, rtol: float = 0.0, atol: float = 0.0,
                 what: str = "") -> None:
    """|got - want| <= atol + rtol * |want| elementwise; `atol` may be an
    array broadcastable to the operands. Failure prints the stated tolerance
    and the worst offender."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}"
    assert np.isfinite(got).all(), f"{what}: non-finite values in the port's result"
    bound = np.asarray(atol, np.float64) + rtol * np.abs(want)
    err = np.abs(got - want)
    bad = err > bound
    if bad.any():
        i = np.unravel_index(np.argmax(err - bound), err.shape)
        raise AssertionError(
            f"{what}: {int(bad.sum())}/{err.size} elements over the stated "
            f"tolerance (rtol={rtol:g}, atol={np.max(atol):g}); worst at {i}: "
            f"got {got[i]!r}, want {want[i]!r}, |diff| {err[i]:.3e}")


def assert_equal(got, want, what: str = "") -> None:
    """Exact equality of integer artefacts (packed bytes, codes, tokens)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}"
    if not np.array_equal(got, want):
        n = int((got != want).sum())
        raise AssertionError(f"{what}: {n}/{got.size} elements differ (must be exact)")


def _cluster_one(w: np.ndarray, k: int):
    """Quantile clustering of one (d_in, d_out) matrix: K equal-mass bins,
    each centroid its bin's mean."""
    edges = np.quantile(w, np.linspace(0, 1, k + 1)[1:-1])
    codes = np.searchsorted(edges, w).astype(np.uint8)
    cb = np.array([w[codes == j].mean() if (codes == j).any() else 0.0
                   for j in range(k)], np.float32)
    return codes, cb


def cluster_params(params, nbits: int = 4, act_scale: Optional[float] = None,
                   smooth_seed: Optional[int] = None):
    """The reference's dense params with every attention / MLP projection
    replaced by a stacked reference ClusteredTensor (codes, codebook, smooth,
    packed, inv_scale, act_scale — the layout `compress_model` emits). With
    `smooth_seed` the smoothing vectors are random in [0.5, 1.5] instead of
    ones; with `act_scale` the quantized Eq. 11 path is armed."""
    rng = np.random.default_rng(smooth_seed)

    def one(w):
        w = np.asarray(w, np.float32)                      # (L, d_in, d_out)
        n_l, d_in, _ = w.shape
        s = (np.ones((n_l, d_in), np.float32) if smooth_seed is None else
             rng.uniform(0.5, 1.5, (n_l, d_in)).astype(np.float32))
        pairs = [_cluster_one(w[l] * s[l][:, None], 1 << nbits) for l in range(n_l)]
        codes = np.stack([c for c, _ in pairs])
        sq = 1.0 if act_scale is None else float(act_scale)
        return RefClusteredTensor(
            codes=jnp.asarray(codes.astype(np.int8)),
            codebook=jnp.asarray(np.stack([cb for _, cb in pairs])),
            smooth=jnp.asarray(s),
            packed=jnp.asarray(np.stack(
                [ref_pack_codes(codes[l], nbits) for l in range(n_l)])),
            inv_scale=jnp.asarray((1.0 / (s * sq)).astype(np.float32)),
            act_scale=None if act_scale is None else jnp.full(
                (n_l,), act_scale, jnp.float32),
            nbits=nbits)

    def walk(tree):
        return {k: (one(v) if k in CLUSTERED_LEAVES else
                    walk(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}
    return walk(params)


def reference_model(arch: str, seed: int = 0, **overrides):
    """(model, dense params) of the reference on a `reduced()` config, f32,
    with per-projection LUT launches (`fused_projections=False`) unless the
    caller overrides it."""
    from repro.models.config import get_config, reduced
    from repro.models.registry import get_model
    cfg = reduced(get_config(arch), **{"dtype": "float32",
                                       "fused_projections": False, **overrides})
    model = get_model(cfg)
    return model, model.init(jax.random.key(seed))


def with_act_scale(ct, s_q: float):
    """A port ClusteredTensor with the quantized Eq. 11 path armed, by
    `dense_to_clustered`'s arithmetic: act_scale = s_q per (stacked) tensor,
    inv_scale = 1/(s_m*s_q) per input channel."""
    s_m = ct.smooth.to(torch.float32)
    return ct._replace(inv_scale=1.0 / (s_m * s_q),
                       act_scale=torch.full(s_m.shape[:-1], s_q, dtype=torch.float32))


def port_model(arch: str, **overrides):
    from repro_torch.models.config import get_config, reduced
    from repro_torch.models.registry import get_model
    return get_model(reduced(get_config(arch), **{
        "dtype": "float32", "fused_projections": False, **overrides}))


@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread for the test. The compression pipeline
    runs thousands of small ops; with the suite's workers sharing the cores,
    each of torch's parallel regions waits on descheduled threads, and a
    reduced llama2-7b compression takes ~57 s instead of ~4 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
