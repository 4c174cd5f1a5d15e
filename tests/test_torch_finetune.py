"""The codebook fine-tune (`examples/distill_llm.py` ft_step) in the port
against the reference, on the CPU.

* The gradients of `kernels/ops.py clustered_linear` and
  `clustered_linear_multi` against `jax.grad` of the reference's (on the CPU
  its "ref" mode, `clustered_matmul`): x, codebook, smooth, and zero for
  `inv_scale`; the float and the calibrated (quantized) transform, 2 / 3 / 4
  bits, M 5 and 130, K = 67 (a multiple of no packing group). Each on the
  port's two routes: the CPU one (`clustered_matmul` under autograd) and the
  card one (`_LutProjections`, reached with `_reaches_kernel` stubbed, its
  kernel wrappers running their plain versions on these CPU tensors).
  Tolerance: 1e-5 of the largest |gradient| of the leaf (f32 sums of at
  most a few hundred terms taken in other orders).
* The backward kernels' plain versions (`lut_matmul_t_ref`,
  `lut_codebook_grad_ref`) against `jax.vjp` of the reference's gather
  contraction, at the same tolerance.
* Three steps of `launch/steps.py build_distill_step` on a `reduced()`
  llama2-7b (f32, `compress_model` at H = 1 with 8 centroids in the
  reference, carried over by `convert.py`) against the example's `ft_step`
  body rebuilt from the reference's modules: the KL per step (rtol 1e-5)
  and every float leaf after each step (atol 2e-5: an Adam step moves a
  leaf by at most lr = 5e-4, and the two gradients differ in their last
  bits); `smooth` moved, `inv_scale` and the integer leaves unchanged.
* The fine-tuned student's logits, served under `torch.no_grad()` (Eq. 11
  through the stale `inv_scale`), against the reference's
  `lut_serving("interpret")` on its fine-tuned student (atol 2e-4, the
  standard of tests/test_torch_forward.py).
* A bf16 tensor under grad: the CPU route multiplies in bf16 as the
  reference does; the card route computes in f32 and rounds its outputs
  and gradients to bf16. Both gaps to the reference's bf16 jax.grad are
  measured against the f32 gradients and bounded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core.api import ClusteredTensor as RefCT
from repro.core.api import clustered_matmul as ref_clustered_matmul
from repro.core.lut import pack_codes as ref_pack_codes
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.kernels import ops as ref_ops
from repro.kernels.ops import lut_serving
from repro.optim.optimizer import OptConfig as RefOptConfig
from repro.optim.optimizer import adam_update as ref_adam_update
from repro.optim.optimizer import init_adam as ref_init_adam
from repro_torch.convert import from_reference
from repro_torch.core.api import ClusteredTensor, is_clustered
from repro_torch.core.lut import pack_codes
from repro_torch.kernels import lut_matmul as port_lm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import lut_codebook_grad_ref, lut_matmul_t_ref
from repro_torch.launch.steps import build_distill_step
from repro_torch.optim.optimizer import OptConfig, init_adam

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (CT_FIELDS, assert_close, np_of, port_model, reference_model,
                  to_numpy_tree)

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

K = 67                 # a multiple of no packing group (2, 8, 4 channels)
GRAD_TOL = 1e-5        # of the leaf's largest |gradient|
ROUTES = ("cpu", "card_function")


def _operands(rng, k, n, nbits, act_scale):
    """One layer's tensor in both packages' form: (numpy fields, nbits)."""
    kc = min(8, 1 << nbits)
    codes = rng.integers(0, kc, (k, n)).astype(np.uint8)
    smooth = rng.uniform(0.5, 2.0, k).astype(np.float32)
    sq = 1.0 if act_scale is None else act_scale
    return dict(codes=codes.astype(np.int8), codebook=np.sort(rng.normal(size=kc)).astype(
        np.float32), smooth=smooth, packed=ref_pack_codes(codes, nbits),
        inv_scale=(1.0 / (smooth * sq)).astype(np.float32),
        act_scale=None if act_scale is None else np.float32(act_scale), nbits=nbits)


def _ref_ct(op, codebook, smooth, inv_scale):
    return RefCT(codes=jnp.asarray(op["codes"]), codebook=codebook, smooth=smooth,
                 packed=jnp.asarray(op["packed"]), inv_scale=inv_scale,
                 act_scale=None if op["act_scale"] is None else jnp.float32(op["act_scale"]),
                 nbits=op["nbits"])


def _ref_grads(ops_list, x, rs, multi):
    """jax.grad of sum_p <y_p, r_p> over (x, then codebook, smooth,
    inv_scale of each projection), the reference's clustered_linear(_multi)
    on the CPU ("ref" mode)."""
    def loss(x, *fields):
        cts = [_ref_ct(op, *fields[3 * p:3 * p + 3]) for p, op in enumerate(ops_list)]
        ys = (ref_ops.clustered_linear_multi(x, cts) if multi
              else (ref_ops.clustered_linear(x, cts[0]),))
        return sum(jnp.sum(y * r) for y, r in zip(ys, rs))

    args = [jnp.asarray(x)] + [jnp.asarray(op[f]) for op in ops_list
                               for f in ("codebook", "smooth", "inv_scale")]
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(args))))(*args)]


def _port_grads(ops_list, x, rs, multi, route, monkeypatch):
    """torch.autograd.grad of the same loss through the port's route."""
    if route == "card_function":
        monkeypatch.setattr(ops, "_reaches_kernel", lambda t: True)
    xt = torch.from_numpy(x).requires_grad_(True)
    cts, leaves = [], [xt]
    for op in ops_list:
        fields = {f: torch.from_numpy(np.asarray(op[f])) for f in CT_FIELDS
                  if op[f] is not None}
        for f in ("codebook", "smooth", "inv_scale"):
            fields[f] = fields[f].clone().requires_grad_(True)
            leaves.append(fields[f])
        fields["codes"] = fields["codes"].to(torch.int8)
        cts.append(ClusteredTensor(nbits=op["nbits"], **{f: fields.get(f) for f in CT_FIELDS}))
    ys = (ops.clustered_linear_multi(xt, cts) if multi else (ops.clustered_linear(xt, cts[0]),))
    loss = sum((y * torch.from_numpy(r)).sum() for y, r in zip(ys, rs))
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [np.zeros(tuple(v.shape), np.float32) if g is None else np_of(g)
            for g, v in zip(got, leaves)]


def _compare(got, want, names):
    for g, w, name in zip(got, want, names):
        if name.endswith("inv_scale"):
            assert not np.any(w) and not np.any(g), name     # neither reads it
            continue
        assert np.abs(w).max() > 0, name
        assert_close(g, w, atol=GRAD_TOL * float(np.abs(w).max()), what=name)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("act_scale", [None, 0.05], ids=["float", "quant"])
@pytest.mark.parametrize("m", [5, 130])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_clustered_linear_grads_equal_the_reference(nbits, m, act_scale, route, monkeypatch):
    """The separating input of the fault the route repairs: the port used to
    differentiate its serving transform (x * inv_scale, rounded when
    act_scale is set), so `smooth` got no gradient, `inv_scale` one, and the
    quantized transform cut x's."""
    rng = np.random.default_rng(100 * nbits + m)
    op = _operands(rng, K, 48, nbits, act_scale)
    x = rng.normal(size=(m, K)).astype(np.float32)
    rs = [rng.normal(size=(m, 48)).astype(np.float32)]
    want = _ref_grads([op], x, rs, multi=False)
    got = _port_grads([op], x, rs, False, route, monkeypatch)
    _compare(got, want, ["x", "codebook", "smooth", "inv_scale"])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("act_scale", [None, 0.05], ids=["float", "quant"])
@pytest.mark.parametrize("m", [5, 130])
def test_clustered_linear_multi_grads_equal_the_reference(m, act_scale, route, monkeypatch):
    """Three projections at 4, 3 and 2 bits sharing x (one B3 / B4 launch
    forward on the card), the first with the calibrated transform when
    act_scale is set: x's gradient sums the three in projection order."""
    rng = np.random.default_rng(7 + m)
    widths = (48, 20, 9)
    ops_list = [_operands(rng, K, n, nb, act_scale if p == 0 else None)
                for p, (n, nb) in enumerate(zip(widths, (4, 3, 2)))]
    x = rng.normal(size=(m, K)).astype(np.float32)
    rs = [rng.normal(size=(m, n)).astype(np.float32) for n in widths]
    want = _ref_grads(ops_list, x, rs, multi=True)
    got = _port_grads(ops_list, x, rs, True, route, monkeypatch)
    names = ["x"] + [f"{p}.{f}" for p in range(3) for f in ("codebook", "smooth", "inv_scale")]
    _compare(got, want, names)


@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_backward_plain_versions_equal_the_reference_vjp(nbits):
    """lut_matmul_t_ref (and the wrapper on CPU tensors) = the vjp of the
    reference's `xs @ codebook[codes]` in xs; lut_codebook_grad_ref on Xs
    (and the wrapper on x) = its vjp in the codebook, and in smooth through
    x / smooth. K is padded to the packing group as the card route pads it
    (zero x columns, unit smooth)."""
    rng = np.random.default_rng(nbits)
    op = _operands(rng, K, 40, nbits, None)
    kc = op["packed"].shape[0] * 8 // nbits
    x = rng.normal(size=(9, K)).astype(np.float32)
    dy = rng.normal(size=(9, 40)).astype(np.float32)
    ct = _ref_ct(op, jnp.asarray(op["codebook"]), jnp.asarray(op["smooth"]),
                 jnp.asarray(op["inv_scale"]))

    def y_of(x, cb, s):
        return ref_clustered_matmul(x, ct._replace(codebook=cb, smooth=s))
    _, vjp = jax.vjp(y_of, jnp.asarray(x), ct.codebook, ct.smooth)
    gx, gcb, gs = (np.asarray(g) for g in vjp(jnp.asarray(dy)))

    pk = torch.from_numpy(op["packed"])
    cb16 = torch.zeros(16)
    cb16[:len(op["codebook"])] = torch.from_numpy(op["codebook"])
    s_pad = torch.ones(kc)
    s_pad[:K] = torch.from_numpy(op["smooth"])
    xp = torch.zeros(9, kc)
    xp[:, :K] = torch.from_numpy(x)
    xs = xp / s_pad
    dyt = torch.from_numpy(dy)
    for fn in (lut_matmul_t_ref, port_lm.lut_matmul_t):
        dxs = fn(dyt, pk, cb16, nbits=nbits)
        assert tuple(dxs.shape) == (9, kc)
        assert_close(np_of(dxs[:, :K] / s_pad[:K]), gx,
                     atol=GRAD_TOL * float(np.abs(gx).max()), what=f"{fn.__name__} dx")
    # the plain version takes Xs, the wrapper x (it divides by smooth itself)
    for fn, first in ((lut_codebook_grad_ref, xs), (port_lm.lut_codebook_grad, xp)):
        dcb, dsm = fn(first, dyt, pk, cb16, s_pad, nbits=nbits)
        assert not dcb[len(op["codebook"]):].any()
        assert_close(np_of(dcb[:len(op["codebook"])]), gcb,
                     atol=GRAD_TOL * float(np.abs(gcb).max()), what=f"{fn.__name__} dcodebook")
        assert_close(np_of(dsm[:K]), gs, atol=GRAD_TOL * float(np.abs(gs).max()),
                     what=f"{fn.__name__} dsmooth")


def test_backward_wrappers_refuse_bad_operands():
    pk = torch.from_numpy(pack_codes(np.zeros((8, 4), np.uint8), 4))
    cb, dy = torch.zeros(16), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="codebook must be"):
        port_lm.lut_matmul_t(dy, pk, torch.zeros(8), nbits=4)
    with pytest.raises(ValueError, match="dy must be"):
        port_lm.lut_matmul_t(torch.zeros(3, 5), pk, cb, nbits=4)
    with pytest.raises(TypeError, match="dy must be float32"):
        port_lm.lut_matmul_t(dy.double(), pk, cb, nbits=4)
    with pytest.raises(ValueError, match="whole number of channels"):
        port_lm.lut_matmul_t(dy, pk[:2], cb, nbits=3)
    with pytest.raises(ValueError, match="contiguous"):
        port_lm.lut_codebook_grad(torch.zeros(8, 3).T, dy, pk, cb, torch.ones(8), nbits=4)
    with pytest.raises(ValueError, match="smooth must be"):
        port_lm.lut_codebook_grad(torch.zeros(3, 8), dy, pk, cb, torch.ones(7), nbits=4)


# ---------------------------------------------------------------------------
# bf16 under grad
# ---------------------------------------------------------------------------

def test_bf16_grads_gap_to_the_reference(monkeypatch):
    """At bf16 the reference multiplies in bf16 (x / smooth and the gathered
    codebook cast to x's dtype). The port's CPU route does the same; its
    card route keeps f32 inside and rounds outputs and gradients to bf16.
    Against the f32 gradients, the reference's bf16 error and the port's
    are measured: the CPU route within 1.5x the reference's own error, the
    card route no worse than it (f32 inside is the more accurate)."""
    rng = np.random.default_rng(5)
    op = _operands(rng, 256, 96, 4, None)
    x = rng.normal(size=(130, 256)).astype(np.float32)
    r = rng.normal(size=(130, 96)).astype(np.float32)
    exact = _ref_grads([op], x, [r], multi=False)

    def ref_bf16():
        def loss(x, cb, s):
            ct = _ref_ct(op, cb, s, jnp.asarray(op["inv_scale"]))
            return jnp.sum(ref_ops.clustered_linear(x, ct).astype(jnp.float32) * r)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        g = jax.grad(loss, argnums=(0, 1, 2))(xb, jnp.asarray(op["codebook"]),
                                              jnp.asarray(op["smooth"]))
        return [np.asarray(a.astype(jnp.float32)) for a in g]

    def port_bf16(route):
        monkeypatch.setattr(ops, "_reaches_kernel", lambda t: route == "card_function")
        xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
        cb = torch.from_numpy(op["codebook"]).requires_grad_(True)
        s = torch.from_numpy(op["smooth"]).requires_grad_(True)
        ct = ClusteredTensor(codes=torch.from_numpy(op["codes"]), codebook=cb, smooth=s,
                             packed=torch.from_numpy(op["packed"]),
                             inv_scale=torch.from_numpy(op["inv_scale"]), nbits=4)
        y = ops.clustered_linear(xt, ct)
        assert y.dtype == torch.bfloat16
        g = torch.autograd.grad((y.float() * torch.from_numpy(r)).sum(), [xt, cb, s])
        return [np_of(a) for a in g]

    def rel(got):
        return [float(np.abs(g - e).max() / np.abs(e).max()) for g, e in zip(got, exact)]

    ref_err = rel(ref_bf16())
    cpu_err, card_err = rel(port_bf16("cpu")), rel(port_bf16("card_function"))
    for name, a, b, c in zip(("x", "codebook", "smooth"), ref_err, cpu_err, card_err):
        assert a < 5e-2, (name, a)
        assert b <= 1.5 * a + 1e-3, (name, a, b)
        assert c <= a + 1e-3, (name, a, c)


# ---------------------------------------------------------------------------
# the fine-tune: build_distill_step against the example's ft_step
# ---------------------------------------------------------------------------

FT_STEPS = 3


def _ref_ft_step(model, teacher, ft_cfg):
    """The body of examples/distill_llm.py's ft_step, from the reference's
    modules."""
    vocab = model.cfg.vocab

    @jax.jit
    def ft_step(student, ft_opt, batch):
        def kd(p):
            t_logits, _ = model.apply(teacher, batch)
            s_logits, _ = model.apply(p, batch)
            t = jax.nn.log_softmax(t_logits[..., :vocab].astype(jnp.float32))
            s = jax.nn.log_softmax(s_logits[..., :vocab].astype(jnp.float32))
            return jnp.mean(jnp.sum(jnp.exp(t) * (t - s), axis=-1))
        kl, g = jax.value_and_grad(kd, allow_int=True)(student)
        student, ft_opt, _ = ref_adam_update(ft_cfg, student, g, ft_opt)
        return student, ft_opt, kl
    return ft_step


def _np_tree(tree):
    """The port's tree as nested dicts of numpy arrays, a ClusteredTensor as
    `to_numpy_tree` spells the reference's."""
    if is_clustered(tree):
        return {**{f: np_of(getattr(tree, f)) for f in CT_FIELDS}, "nbits": tree.nbits}
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np_of(tree)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


@pytest.fixture(scope="module")
def fine_tuned():
    """Both packages' students after each of FT_STEPS steps, from the same
    reference-compressed start; the KL per step; the start."""
    model, teacher = reference_model("llama2-7b", seed=3, fused_projections=True)
    student, _ = ref_api.compress_model(teacher, target_centroids=8, nbits=4)
    cfg = model.cfg
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, batch_size=2, seed=0))
    batches = [data.batch(1000 + i) for i in range(FT_STEPS)]

    ref_step = _ref_ft_step(model, teacher, RefOptConfig(
        lr=5e-4, warmup_steps=0, total_steps=FT_STEPS, weight_decay=0.0))
    rs, ropt, ref_kl, ref_trees = student, ref_init_adam(student), [], []
    for b in batches:
        rs, ropt, kl = ref_step(rs, ropt, {k: jnp.asarray(v) for k, v in b.items()})
        ref_kl.append(float(kl))
        ref_trees.append(to_numpy_tree(rs))

    pmodel = port_model("llama2-7b", fused_projections=True)
    start = from_reference(to_numpy_tree(student), device="cpu")
    step = build_distill_step(pmodel, from_reference(to_numpy_tree(teacher), device="cpu"),
                              OptConfig(lr=5e-4, warmup_steps=0, total_steps=FT_STEPS,
                                        weight_decay=0.0))
    ps, popt, port_kl, port_trees = start, init_adam(start), [], []
    for b in batches:
        ps, popt, kl = step(ps, popt, {k: torch.from_numpy(v) for k, v in b.items()})
        port_kl.append(float(kl))
        port_trees.append(_np_tree(ps))
    return dict(model=model, pmodel=pmodel, ref=(rs, ref_kl, ref_trees),
                port=(ps, port_kl, port_trees), start=_np_tree(start), batches=batches)


def test_distill_step_kl_per_step_equals_the_reference(fine_tuned):
    _, ref_kl, _ = fine_tuned["ref"]
    _, port_kl, _ = fine_tuned["port"]
    assert all(np.isfinite(port_kl)) and port_kl[0] > 0
    assert_close(port_kl, ref_kl, rtol=1e-5, what="KL per step")


@pytest.mark.parametrize("step", range(FT_STEPS))
def test_distill_step_leaves_equal_the_reference(fine_tuned, step):
    """Every leaf after `step` + 1 steps: floats to atol 2e-5, integers
    exact."""
    got, want = fine_tuned["port"][2][step], fine_tuned["ref"][2][step]
    n = 0
    for path, g, w in _pairs(got, want):
        if path.endswith("nbits") or w is None:
            assert g is None or path.endswith("nbits"), path
            continue
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            assert np.array_equal(g, w), path
        else:
            assert_close(g, w, atol=2e-5, what=f"step {step + 1} {path}")
        n += 1
    assert n > 30


def test_distill_step_moves_codebooks_and_smooth_not_inv_scale(fine_tuned):
    """Across the fine-tune: every codebook and smoothing vector moved, and
    the dense leaves; `inv_scale`, codes and packed bytes are the start's,
    in both packages (the reference leaves `inv_scale` stale too)."""
    start = fine_tuned["start"]
    for tree in (fine_tuned["port"][2][-1], fine_tuned["ref"][2][-1]):
        moved = {}
        for path, a, b in _pairs(tree, start):
            if path.endswith("nbits") or a is None:
                continue
            moved[path] = not np.array_equal(a, b)
        for path, m in moved.items():
            field = path.rsplit("/", 1)[-1]
            if field in ("codebook", "smooth", "embed", "lm_head"):
                assert m, path
            elif field in ("inv_scale", "codes", "packed"):
                assert not m, path


def test_served_student_after_the_fine_tune_equals_the_reference_interpret(fine_tuned):
    """The fine-tuned students evaluated: the port under torch.no_grad()
    (the serving route, plain versions on the CPU, Eq. 11 through the stale
    `inv_scale`) against the reference's Pallas kernels in interpret mode;
    both differ from the same students through the float route."""
    model, pmodel = fine_tuned["model"], fine_tuned["pmodel"]
    rs, ps = fine_tuned["ref"][0], fine_tuned["port"][0]
    batch = fine_tuned["batches"][0]
    with lut_serving("interpret"):
        want, _ = jax.jit(model.apply)(rs, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got, _ = pmodel.apply(ps, tb)
    assert_close(np_of(got), np.asarray(want), atol=2e-4, what="served logits after fine-tune")
    with lut_serving("ref"):
        trained, _ = jax.jit(model.apply)(rs, {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(np.abs(np.asarray(trained) - np.asarray(want)).max()) > 1e-3
