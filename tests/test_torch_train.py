"""The port's optimizer, gradient compression, step builders and trainer
against the reference's (`optim/optimizer.py`, `optim/compress.py`,
`launch/steps.py`, `launch/train.py`), the same numpy inputs through both;
the trainer's contracts within the port (the loss falls, microbatches =
the full batch, resume); on the card, gradients through the LUT path take
the backward kernels (device check and wrappers stubbed); and
`compress_model` with the empirical Fisher of a real LM loss.

Tolerances: `lr_at`, `global_norm` and one `adam_update` rtol 1e-6 (integer
leaves exact); `compress_decompress` / `apply_ef` exact (the same f32
arithmetic, round half to even); one train step: loss and gradient norm
rtol 1e-5, raw gradients atol 2e-6 of the leaf's largest |g|, updated
parameters atol 1e-6 + rtol 1e-5, except on at most 1 % of the elements (and
per leaf at most 1 % or 2 elements), held to 2 * lr (the span of Adam's
first step): those whose gradient is nonzero and below 1e3 * eps (Adam's
first step g / (|g| + eps) magnifies an f32 difference there) and, with
`grad_compress`, those whose reference int8 quotient (g + r) / scale lies
within 127 * 2e-6 of a .5 rounding boundary (the gradient tolerance in
quotient units: only there can the two packages' gradients take
neighbouring codes); Adam's first moment and the new error-feedback
residual atol 2 * 2e-6 of the leaf's largest, plus one quantization step
(1/127 of it) at those boundary elements; microbatch 4 = full
batch loss rel 1e-4, parameters rtol 1e-3 atol 1e-5 (the reference's
`tests/test_steps_system.py`); the trainer's loss falls by >= 0.2 as the
reference's does; compression under the Fisher to the standard of
`tests/test_torch_compress.py` (codes and packed bytes exact, codebooks
rtol 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import calibration_batches as ref_calibration
from repro.distributed.sharding import use_rules
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh
from repro.models import config as ref_config
from repro.models.registry import get_model as ref_get_model
from repro.models.registry import lm_loss as ref_lm_loss
from repro.optim import compress as ref_compress
from repro.optim import optimizer as ref_opt
from repro_torch.convert import from_reference
from repro_torch.core import api as port_api
from repro_torch.data.pipeline import DataConfig, SyntheticLM, calibration_batches
from repro_torch.distributed.sharding import use_rules as port_use_rules
from repro_torch.kernels import ops
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_host_mesh as port_make_host_mesh
from repro_torch.models import config as port_config
from repro_torch.models.registry import get_model, lm_loss
from repro_torch.optim import compress as port_compress
from repro_torch.optim import optimizer as port_opt
from repro_torch.tree import flatten_with_paths, leaves
from repro_torch.tree import unflatten as port_unflatten

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (assert_close, assert_equal, np_of, reference_model,
                  to_numpy_tree)
from test_torch_compress import _assert_same_compression

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

TINY = dict(arch_id="steps-tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, dtype="float32")


def _port(tree):
    return from_reference(to_numpy_tree(tree), device="cpu")


def _tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# optimizer and gradient compression
# ---------------------------------------------------------------------------

def test_lr_schedule_equals_the_reference():
    for cfg in (ref_opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100),
                ref_opt.OptConfig(lr=3e-4, warmup_steps=0, total_steps=30, min_lr_frac=0.0),
                ref_opt.OptConfig()):
        pcfg = port_opt.OptConfig(**dataclasses.asdict(cfg))
        for s in (0, 1, 5, 10, 11, 50, 99, 100, 250, 20000):
            want = float(ref_opt.lr_at(cfg, jnp.asarray(s)))
            got = float(port_opt.lr_at(pcfg, torch.tensor(s, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (cfg, s)
    assert dataclasses.asdict(port_opt.OptConfig()) == dataclasses.asdict(ref_opt.OptConfig())


def _opt_tree(rng):
    """A parameter tree with f32 matrices (decayed), an f32 vector (not
    decayed), a bf16 matrix and an int8 leaf (frozen), as numpy."""
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "blk": {"b": rng.normal(size=(5,)).astype(np.float32),
                    "h": rng.normal(size=(3, 4)).astype(np.float32)},
            "codes": rng.integers(-8, 8, (4, 3)).astype(np.int8)}


@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_one_adam_update_equals_the_reference(clip):
    rng = np.random.default_rng(3)
    p_np, g_np = _opt_tree(rng), _opt_tree(rng)
    g_np["codes"] = np.zeros((4, 3), np.float32)
    m_np, v_np = _opt_tree(rng), _opt_tree(rng)
    for t in (m_np, v_np):
        t["codes"] = np.zeros((4, 3), np.float32)
    v_np = jax.tree_util.tree_map(np.abs, v_np)
    cfg = ref_opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip)
    bf = {"h"}                       # carried in bfloat16 on both sides

    def ref_t(t, cast=True):
        return jax.tree_util.tree_map_with_path(
            lambda kp, a: jnp.asarray(a, jnp.bfloat16 if cast and
                                      jax.tree_util.keystr(kp).endswith("['h']") else None), t)

    def port_t(t, cast=True):
        def walk(d):
            return {k: walk(v) if isinstance(v, dict) else
                    torch.from_numpy(v.copy()).to(torch.bfloat16 if cast and k in bf else None)
                    for k, v in d.items()}
        return walk(t)

    rstate = ref_opt.AdamState(jnp.asarray(3, jnp.int32), ref_t(m_np, False), ref_t(v_np, False))
    want_p, want_s, want_n = ref_opt.adam_update(cfg, ref_t(p_np), ref_t(g_np), rstate)
    pstate = port_opt.AdamState(torch.tensor(3, dtype=torch.int32), port_t(m_np, False),
                                port_t(v_np, False))
    got_p, got_s, got_n = port_opt.adam_update(port_opt.OptConfig(**dataclasses.asdict(cfg)),
                                               port_t(p_np), port_t(g_np), pstate)
    assert float(got_n) == pytest.approx(float(want_n), rel=1e-6)
    assert float(port_opt.global_norm(port_t(g_np))) == pytest.approx(
        float(ref_opt.global_norm(ref_t(g_np))), rel=1e-6)
    assert isinstance(got_s, port_opt.AdamState) and int(got_s.step) == 4
    assert got_s.step.dtype == torch.int32
    for (path, got), want in zip(
            flatten_with_paths((got_p, got_s.m, got_s.v)),
            jax.tree_util.tree_leaves((want_p, want_s.m, want_s.v))):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), path
        assert_close(np_of(got), np_of(want), rtol=1e-6, atol=1e-7, what=path)
    assert torch.equal(got_p["codes"], port_t(p_np)["codes"])          # frozen
    assert not torch.equal(got_p["w"], port_t(p_np)["w"])


def test_adam_minimizes_a_quadratic_and_clips():
    cfg = port_opt.OptConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0,
                             clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = port_opt.init_adam(params)
    for _ in range(200):
        params, state, _ = port_opt.adam_update(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.05
    st = port_opt.init_adam({"w": torch.zeros(3)})
    _, _, gnorm = port_opt.adam_update(port_opt.OptConfig(lr=1e-3, warmup_steps=0),
                                       {"w": torch.zeros(3)},
                                       {"w": torch.tensor([1e3, 0.0, 0.0])}, st)
    assert float(gnorm) == pytest.approx(1e3)


def test_compress_decompress_and_apply_ef_equal_the_reference():
    rng = np.random.default_rng(7)
    g = {"a": rng.normal(size=(64,)).astype(np.float32),
         "b": {"c": (rng.normal(size=(8, 9)) * 1e-3).astype(np.float32)}}
    r = {"a": rng.normal(size=(64,)).astype(np.float32) * 0.01,
         "b": {"c": np.zeros((8, 9), np.float32)}}
    for key in ("a",):
        want = ref_compress.compress_decompress(jnp.asarray(g[key]), jnp.asarray(r[key]))
        got = port_compress.compress_decompress(torch.from_numpy(g[key]), torch.from_numpy(r[key]))
        for a, b in zip(got, want):
            assert_equal(np_of(a), np.asarray(b), "compress_decompress")
    ref_ef = ref_compress.EFState(jax.tree_util.tree_map(jnp.asarray, r))
    port_ef = port_compress.EFState(jax.tree_util.tree_map(torch.from_numpy, r))
    jg, tg = jax.tree_util.tree_map(jnp.asarray, g), jax.tree_util.tree_map(torch.from_numpy, g)
    for _ in range(3):                        # the residual carries over
        jg_out, ref_ef = ref_compress.apply_ef(jg, ref_ef)
        tg_out, port_ef = port_compress.apply_ef(tg, port_ef)
        for a, b in zip(leaves((tg_out, port_ef.residual)),
                        jax.tree_util.tree_leaves((jg_out, ref_ef.residual))):
            assert_equal(np_of(a), np.asarray(b), "apply_ef")
    ef0 = port_compress.init_ef(tg)
    assert all(x.dtype == torch.float32 and not x.any() for x in leaves(ef0.residual))
    # unbiased over time: the applied gradient converges to the true one
    g1 = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
    ef, applied = port_compress.init_ef(g1), torch.zeros(64)
    for _ in range(50):
        out, ef = port_compress.apply_ef(g1, ef)
        applied += out["w"]
    assert float((applied / 50 - g1["w"]).abs().max()) < 0.02


# ---------------------------------------------------------------------------
# the train step against the reference's jitted step
# ---------------------------------------------------------------------------

def _tiny_pair():
    rcfg = ref_config.ModelConfig(**TINY)
    pcfg = port_config.ModelConfig(**TINY)
    rmodel, pmodel = ref_get_model(rcfg), get_model(pcfg)
    params = rmodel.init(jax.random.key(0))
    return rmodel, pmodel, params


def test_lm_loss_with_a_padded_vocab():
    rng = np.random.default_rng(1)
    vocab, padded = 300, 384
    logits = rng.normal(size=(2, 5, padded)).astype(np.float32) * 3
    logits[..., vocab:] = 50.0                 # padded ids must not count
    targets = rng.integers(0, vocab, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    want = float(ref_lm_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask), vocab))
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(mask),
                  vocab)
    assert got.dtype == torch.float32 and float(got) == pytest.approx(want, rel=1e-6)
    assert float(lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                         torch.zeros(2, 5), vocab)) == 0.0


@pytest.mark.parametrize("grad_compress", [False, True], ids=["plain", "grad_compress"])
def test_one_train_step_equals_the_reference(grad_compress):
    rmodel, pmodel, params = _tiny_pair()
    data = RefSyntheticLM(RefDataConfig(vocab=256, seq_len=32, batch_size=4))
    batch = data.batch(0)
    opt = ref_opt.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    with use_rules(make_host_mesh()):
        b = ref_steps.build_train_step(rmodel, ref_config.ShapeConfig("t", 32, 4, "train"),
                                       opt, grad_compress=grad_compress)
        fn = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
        ef = ref_compress.init_ef(params) if grad_compress else ref_compress.EFState(None)
        want_p, want_o, want_ef, want_m = fn(params, ref_opt.init_adam(params), ef,
                                             _jbatch(batch))
    pp = _port(params)
    step = port_steps.build_train_step(pmodel, port_opt.OptConfig(**dataclasses.asdict(opt)),
                                       grad_compress=grad_compress)
    pef = port_compress.init_ef(pp) if grad_compress else port_compress.EFState(None)
    got_p, got_o, got_ef, got_m = step(pp, port_opt.init_adam(pp), pef, _tbatch(batch))
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]), rel=1e-5)
    assert float(got_m["grad_norm"]) == pytest.approx(float(want_m["grad_norm"]), rel=1e-5)
    assert float(got_m["aux"]) == 0.0 and int(got_o.step) == 1
    # the raw gradients, through each package's own loss and autograd
    def ref_loss(p):
        logits, _ = rmodel.apply(p, _jbatch(batch))
        return ref_lm_loss(logits, jnp.asarray(batch["targets"]),
                           jnp.asarray(batch["loss_mask"]), 256)
    ref_grads = jax.tree_util.tree_leaves(jax.grad(ref_loss)(params))
    grad_tol = 2e-6                       # of the leaf's largest |g|
    tb = _tbatch(batch)
    var = [x.detach().requires_grad_(True) for x in leaves(pp)]
    logits, _ = pmodel.apply(port_unflatten(pp, var), tb)
    port_grads = torch.autograd.grad(lm_loss(logits, tb["targets"], tb["loss_mask"], 256), var)
    n_loose = n_all = 0
    want_r = (jax.tree_util.tree_leaves(want_ef.residual) if grad_compress
              else [None] * len(ref_grads))
    got_r = leaves(got_ef.residual) if grad_compress else [None] * len(ref_grads)
    for path, got, want, grad, pgrad, got_m1, want_m1, gr, wr in zip(
            [p for p, _ in flatten_with_paths(got_p)], leaves(got_p),
            jax.tree_util.tree_leaves(want_p), ref_grads, port_grads,
            leaves(got_o.m), jax.tree_util.tree_leaves(want_o.m), got_r, want_r):
        rg = np.asarray(grad)
        assert_close(np_of(pgrad), rg, rtol=0.0, atol=grad_tol * float(np.abs(rg).max()),
                     what=f"grads {path}")
        g, w = np_of(got), np.asarray(want)
        err = np.abs(g - w)
        flip = np.zeros(g.shape, bool)
        one_step = 2 * opt.lr + 1e-6      # g / (|g| + eps) spans [-1, 1]
        # Adam's first step is g / (|g| + eps): where |g| is a few eps, an f32
        # difference in g moves the step by a visible part of lr
        loose = (rg != 0) & (np.abs(rg) < 1e3 * opt.eps)
        if grad_compress:
            # the reference's int8 quotient (residual 0 at the first step);
            # a gradient within grad_tol of a .5 boundary may take the
            # neighbouring code in the port, which moves Adam's first step
            # by at most one_step
            gf = jnp.asarray(grad).astype(jnp.float32)
            q = np.asarray(gf / (jnp.maximum(jnp.max(jnp.abs(gf)), 1e-30) / 127.0))
            flip = np.abs(np.abs(q) % 1.0 - 0.5) <= 127 * grad_tol
            loose |= flip
            # the new residual g + r - deq: within twice the gradient
            # tolerance, or one quantization step more at a boundary
            gmax = float(np.abs(rg).max())
            assert_close(np_of(gr), np.asarray(wr), atol=np.where(
                flip, gmax / 127, 0.0) + 2 * grad_tol * gmax, what=f"residual {path}")
        # Adam's first moment (1 - beta1) * clip * g is linear in the
        # (compressed) gradient, so it shows a code or a scale the update hides
        mmax = float(np.abs(np.asarray(want_m1)).max())
        assert_close(np_of(got_m1), np.asarray(want_m1), atol=np.where(
            flip, mmax / 127, 0.0) + 2 * grad_tol * mmax, what=f"adam m {path}")
        assert int(loose.sum()) <= max(2, 1e-2 * loose.size), (path, int(loose.sum()))
        n_loose, n_all = n_loose + int(loose.sum()), n_all + loose.size
        assert (err[loose] <= one_step).all(), path
        assert_close(g[~loose], w[~loose], rtol=1e-5, atol=1e-6, what=f"params {path}")
    assert n_loose <= 1e-2 * n_all, (n_loose, n_all)
    assert not torch.equal(got_p["embed"], pp["embed"])
    assert (got_ef.residual is None) != grad_compress


def test_microbatch_matches_full_batch():
    _, model, params = _tiny_pair()
    pp = _port(params)
    batch = _tbatch(SyntheticLM(DataConfig(vocab=256, seq_len=32, batch_size=8)).batch(0))
    outs = {}
    for mb in (0, 4):
        step = port_steps.build_train_step(model, port_opt.OptConfig(lr=1e-3), microbatch=mb)
        p2, _, _, metrics = step(pp, port_opt.init_adam(pp), port_compress.EFState(None), batch)
        outs[mb] = (float(metrics["loss"]), np_of(leaves(p2)[0]))
    assert outs[0][0] == pytest.approx(outs[4][0], rel=1e-4)
    np.testing.assert_allclose(outs[0][1], outs[4][1], rtol=1e-3, atol=1e-5)


def test_prefill_step_is_the_forwards_last_position():
    rmodel, model, params = _tiny_pair()
    pp = _port(params)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(np.int32)
    with port_use_rules(port_make_host_mesh([torch.device("cpu")])):
        got = port_steps.build_prefill_step(model, port_config.ShapeConfig(
            "p", 12, 2, "prefill"))(pp, {"tokens": torch.from_numpy(tokens)})
    assert not got.requires_grad and tuple(got.shape) == (2, model.cfg.padded_vocab)
    with use_rules(make_host_mesh()):
        want = ref_steps.build_prefill_step(rmodel, ref_config.ShapeConfig("p", 12, 2, "prefill")
                                            ).fn(params, {"tokens": jnp.asarray(tokens)})
    assert_close(np_of(got), np.asarray(want), atol=2e-5, what="prefill logits")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_loss_decreases():
    rep = port_train.train("qwen2-1.5b", steps=40, batch=8, seq=64, use_reduced=True,
                           lr=3e-3, log_every=1000, device="cpu")
    assert rep.steps_run == 40 and rep.resumed_from is None and len(rep.losses) == 40
    first, last = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])
    assert last < first - 0.2, (first, last)


def test_trainer_checkpoint_resume(tmp_path):
    d = str(tmp_path / "ck")
    port_train.train("qwen2-1.5b", steps=10, batch=4, seq=32, use_reduced=True, ckpt_dir=d,
                     ckpt_every=5, log_every=1000, device="cpu")
    rep = port_train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "14", "--batch", "4",
                           "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "5",
                           "--grad-compress", "--microbatch", "2", "--device", "cpu"])
    assert rep.resumed_from == 10 and rep.steps_run == 4
    assert np.isfinite(rep.losses).all()
    from repro_torch.checkpoint.manager import CheckpointManager
    assert CheckpointManager(d).all_steps() == [5, 10, 14]


# ---------------------------------------------------------------------------
# gradients through the LUT path on the card: the backward kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True], ids=["solo", "multi"])
def test_grad_requiring_calls_on_the_card_take_the_backward_kernels(monkeypatch, multi):
    """With the device check stubbed to say "the card" and every kernel
    wrapper stubbed: a call that requires grad runs the differentiable
    route's forward (the float transform, inv = 1 / smooth, one launch for
    the group) and, on backward, `lut_matmul_t` and `lut_codebook_grad` once
    per projection, never the serving route (Eq. 11 through `inv_scale`);
    under torch.no_grad() the serving route runs and no backward kernel; a
    stacked codebook still raises."""
    rng = np.random.default_rng(0)
    from repro_torch.core.api import dense_to_clustered

    def tensor(n):
        w = rng.normal(size=(64, n)).astype(np.float32)
        codes = rng.integers(0, 8, (64, n)).astype(np.uint8)
        return dense_to_clustered(w, codes, np.sort(rng.normal(size=8)).astype(np.float32),
                                  smooth=rng.uniform(0.5, 2.0, 64).astype(np.float32),
                                  act_scale=0.05, device="cpu")
    cts = (tensor(32), tensor(16)) if multi else (tensor(32),)
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    calls = []

    def solo(x2, inv, pk, cb, act, *, quantize, nbits):
        calls.append(("forward", 1, quantize, inv))
        return torch.zeros(x2.shape[0], pk.shape[1])

    def group(x2, inv_stack, cb_stack, acts, *pks, quantize, nbits):
        calls.append(("forward", len(pks), quantize, inv_stack))
        return tuple(torch.zeros(x2.shape[0], pk.shape[1]) for pk in pks)

    def t_kernel(dy, pk, cb, *, nbits):
        calls.append(("lut_matmul_t",))
        return torch.zeros(dy.shape[0], pk.shape[0] * 8 // nbits)

    def grad_kernel(xs, dy, pk, cb, smooth, *, nbits):
        calls.append(("lut_codebook_grad",))
        return torch.zeros(16), torch.zeros(xs.shape[1])
    monkeypatch.setattr(ops, "_reaches_kernel", lambda t: True)
    for name, fn in (("lut_gemm_fused", solo), ("lut_gemm_fused_multi", group),
                     ("lut_matmul_t", t_kernel), ("lut_codebook_grad", grad_kernel)):
        monkeypatch.setattr(ops, name, fn)

    def call(x, cts):
        return ops.clustered_linear_multi(x, cts) if multi else (ops.clustered_linear(x, cts[0]),)

    trainable = tuple(ct._replace(codebook=ct.codebook.clone().requires_grad_(True),
                                  smooth=ct.smooth.clone().requires_grad_(True)) for ct in cts)
    xg = x.clone().requires_grad_(True)
    ys = call(xg, trainable)
    (kind, launched, quantize, inv), = calls
    assert kind == "forward" and launched == len(cts) and not any(np.atleast_1d(quantize))
    want_inv = torch.stack([1.0 / ct.smooth for ct in cts])
    assert torch.equal(inv.reshape(want_inv.shape), want_inv)
    assert not any(torch.equal(inv.reshape(want_inv.shape)[p], ct.inv_scale)
                   for p, ct in enumerate(cts))
    grads = torch.autograd.grad(sum(y.sum() for y in ys),
                                [xg, *[f for ct in trainable for f in (ct.codebook, ct.smooth)]])
    assert [c[0] for c in calls[1:]] == ["lut_matmul_t", "lut_codebook_grad"] * len(cts)
    assert all(g is not None for g in grads)
    calls.clear()
    with torch.no_grad():
        call(xg, trainable)
    (kind, launched, quantize, inv), = calls
    assert all(np.atleast_1d(quantize))
    assert torch.equal(inv.reshape(want_inv.shape),
                       torch.stack([ct.inv_scale for ct in cts]))
    stacked = cts[0]._replace(codebook=cts[0].codebook.expand(2, -1).clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="stacked codebook"):
        ops.clustered_linear(xg, stacked)


# ---------------------------------------------------------------------------
# the paper's pipeline: compress_model under the empirical Fisher of an LM
# ---------------------------------------------------------------------------

def test_compress_model_with_the_fisher_of_an_lm_equals_the_reference():
    """`compress_model(loss_fn=Model.apply + lm_loss, calib_batches=
    calibration_batches(n=2))` on a reduced llama2-7b: the port's Fisher by
    torch.autograd through `forward`, the reference's by jax.grad; the same
    compression, and another one than with H = 1."""
    rmodel, dense = reference_model("llama2-7b", seed=3, fused_projections=True)
    pmodel = get_model(port_config.reduced(port_config.get_config("llama2-7b"),
                                           dtype="float32", fused_projections=True))
    dcfg = dict(vocab=rmodel.cfg.vocab, seq_len=32, batch_size=4, seed=0)
    rcal = [_jbatch(b) for b in ref_calibration(RefDataConfig(**dcfg), n=2)]
    pcal = [_tbatch(b) for b in calibration_batches(DataConfig(**dcfg), n=2)]

    def ref_loss(p, b):
        logits, _ = rmodel.apply(p, b)
        return ref_lm_loss(logits, b["targets"], b["loss_mask"], rmodel.cfg.vocab)

    def port_loss(p, b):
        logits, _ = pmodel.apply(p, b)
        return lm_loss(logits, b["targets"], b["loss_mask"], pmodel.cfg.vocab)

    pdense = _port(dense)
    fisher = port_api._fisher(pdense, port_api._flatten_with_paths(pdense), port_loss, pcal)
    grads = [jax.grad(ref_loss)(dense, b) for b in rcal]
    for path, leaf in ref_api._flatten_with_paths(dense):
        want = np.mean([np.asarray(dict(ref_api._flatten_with_paths(g))[path]) ** 2
                        for g in grads], axis=0)
        assert_close(np_of(fisher[path]), want, rtol=1e-3, atol=1e-6 * want.max(),
                     what=f"Fisher {path}")
    want = ref_api.compress_model(dense, loss_fn=ref_loss, calib_batches=rcal,
                                  target_centroids=8, nbits=4)
    got = port_api.compress_model(pdense, loss_fn=port_loss, calib_batches=pcal,
                                  target_centroids=8, nbits=4)
    _assert_same_compression(got, want, "fisher lm")
    h1 = port_api.compress_model(pdense, target_centroids=8, nbits=4)
    path = "['blocks']['mlp']['w_down']"
    assert not torch.equal(dict(port_api._flatten_with_paths(got[0]))[path].codes,
                           dict(port_api._flatten_with_paths(h1[0]))[path].codes)
