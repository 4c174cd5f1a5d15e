"""The arithmetic of the LUT backward kernels on the tensor cores, on the CPU.

On the card `lut_matmul_t` and `lut_codebook_grad` take each f32 operand as
two bf16 parts (`split_bf16`: hi = bf16(v), lo = bf16(v - hi)) and a product
as three bf16 products with f32 accumulators, hi*hi in one and the
corrections lo*hi + hi*lo in another (csrc/lut_backward.cu). The kernels run
only on the card; here the same arithmetic is emulated in torch (bf16 parts,
exact in f32; f32 products and sums) at fine-tune-like operands and held to
an f64 truth within chip_smoke.py's BACKWARD_TOL fractions, the limits the
kernels are held to on the card. A witness shows the hi parts alone miss
them, so the limits see the lo terms. The split's plain version and its
wrapper's CPU route are checked too.
"""
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.lut import pack_codes, unpack_codes
from repro_torch.kernels import lut_matmul as port_lm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import split_bf16_ref

pytestmark = pytest.mark.tier1

M, K, N = 256, 512, 1024     # rows, channels, columns


@functools.lru_cache(maxsize=None)
def _backward_tol():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.BACKWARD_TOL


def _operands(nbits, seed):
    """x, smooth, dy as f64 arrays rounded to f32, codes, a 16-entry codebook
    of fine-tune scale (chip_smoke.py `_lut_operands`), packed codes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    smooth = (0.5 + rng.random(K)).astype(np.float32)
    dy = rng.normal(size=(M, N)).astype(np.float32)
    codes = rng.integers(0, 1 << nbits, (K, N)).astype(np.uint8)
    cb = np.zeros(16, np.float32)
    cb[:1 << nbits] = np.sort(rng.normal(size=1 << nbits) * 0.02)
    return x, smooth, dy, codes, cb, pack_codes(codes, nbits)


def _split_mm(a, b, lo_terms=True):
    """a @ b as the kernels take it: (hi*hi) + (lo*hi + hi*lo), the parts in
    f32 (exact), f32 products and sums."""
    (ah, al), (bh, bl) = ([p.to(torch.float32) for p in split_bf16_ref(t)] for t in (a, b))
    main = ah @ bh
    return main + (al @ bh + ah @ bl) if lo_terms else main


def _gradients(x, smooth, dy, codes, cb, lo_terms):
    """dXs, dx, dsmooth, dcodebook through the split, in f32 (torch)."""
    xt, st, dyt = (torch.from_numpy(a) for a in (x, smooth, dy))
    ct, cbt = torch.from_numpy(codes).long(), torch.from_numpy(cb)
    w = cbt[ct]                                                    # (K, N)
    xs = xt / st
    dxs = _split_mm(dyt, w.T.contiguous(), lo_terms)
    g = _split_mm(xs.T.contiguous(), dyt, lo_terms)                # (K, N)
    dcb = torch.zeros(16).index_add_(0, ct.reshape(-1), g.reshape(-1))
    return dict(dxs=dxs, dx=dxs / st, dsmooth=-(g * w).sum(dim=1) / st, dcodebook=dcb)


def _truth(x, smooth, dy, codes, cb):
    x, smooth, dy, cb = (a.astype(np.float64) for a in (x, smooth, dy, cb))
    w = cb[codes]
    dxs = dy @ w.T
    g = (x / smooth).T @ dy
    dcb = np.bincount(codes.reshape(-1), weights=g.reshape(-1), minlength=16)
    return dict(dxs=dxs, dx=dxs / smooth, dsmooth=-(g * w).sum(axis=1) / smooth, dcodebook=dcb)


def _worst(got, want, tol):
    """The largest error of each gradient over its limit, tol[name] of the
    largest |gradient|."""
    return {n: float(np.abs(got[n].numpy() - want[n]).max()) / (tol[n] * np.abs(want[n]).max())
            for n in want}


@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_split_products_hold_the_backward_tolerances(nbits):
    """Every gradient through the split within BACKWARD_TOL of the f64 truth,
    with room to spare (a quarter of the limit); the hi parts alone miss
    the limits of dXs, dx and dsmooth."""
    tol = _backward_tol()
    ops_ = _operands(nbits, seed=nbits)
    want = _truth(*ops_[:5])
    ratio = _worst(_gradients(*ops_[:5], lo_terms=True), want, tol)
    assert all(r <= 0.25 for r in ratio.values()), ratio
    hi_only = _worst(_gradients(*ops_[:5], lo_terms=False), want, tol)
    assert all(hi_only[n] > 1 for n in ("dxs", "dx", "dsmooth")), hi_only


def test_split_bf16_parts():
    """hi = bf16(v) rounded to nearest, lo = bf16(v - hi), hi + lo exact in
    f32 and within 2^-16 of v; with smooth, v = x / smooth (the f32
    division); the wrapper's CPU route is the plain version's bits."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(33, 40)) * 10.0 ** rng.integers(-6, 6, (33, 40)))
                         .astype(np.float32))
    smooth = torch.from_numpy((0.5 + rng.random(40)).astype(np.float32))
    for s in (None, smooth):
        v = x if s is None else x / s
        hi, lo = split_bf16_ref(x, s)
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert torch.equal(hi, v.to(torch.bfloat16))
        whole = hi.double() + lo.double()
        assert torch.equal(whole.float().double(), whole)          # exact in f32
        assert float(((whole - v.double()).abs() / v.double().abs()).max()) <= 2.0 ** -16
        for got, want in zip(port_lm.split_bf16(x, s), (hi, lo)):
            assert torch.equal(got, want)
    with pytest.raises(TypeError, match="float32"):
        port_lm.split_bf16(x.double())
    with pytest.raises(ValueError, match="smooth must be"):
        port_lm.split_bf16(x, smooth[:3])


def test_wrappers_on_cpu_read_the_f32_operands():
    """On CPU tensors the backward wrappers run their plain versions on the
    f32 operands: a dy_split passed beside dy does not change their bits,
    and lut_codebook_grad's x / smooth is the plain version's Xs. No launch
    is counted."""
    x, smooth, dy, codes, cb, packed = (torch.from_numpy(a) for a in _operands(4, seed=9))
    xs = x / smooth
    ops.reset_launch_counts()
    split = split_bf16_ref(dy)
    for kw in ({}, {"dy_split": split}):
        dxs = port_lm.lut_matmul_t(dy, packed, cb, nbits=4, **kw)
        dcb, dsm = port_lm.lut_codebook_grad(x, dy, packed, cb, smooth, nbits=4, **kw)
        w = cb[unpack_codes(packed, K, 4).long()]
        assert torch.equal(dxs, dy @ w.T)
        want_dcb, want_dsm = port_lm.lut_codebook_grad_ref(xs, dy, packed, cb, smooth, nbits=4)
        assert torch.equal(dcb, want_dcb) and torch.equal(dsm, want_dsm)
    assert not any(ops.launch_counts().values())
