"""Training on a (data, model) mesh: the port's train bundle, placement and
mesh step against the JAX package's `build_train_step` and against the
port's own one-device step.

The training specs (params, Adam `m` / `v` / `count`, EF residuals, batch)
of every arch's `reduced()` table equal the reference bundle's on the
stand-in mesh shapes of `test_torch_sharding.py` (1 x 1, 1 x 8, 2 x 4,
8 x 1, (2, 16, 16)); every arch takes a train step on (2, 1) and (1, 2)
with 1 x 1's loss and gradient norm. Then on meshes of repeated CPU devices
(`[cpu] x n`) 3 steps of a tiny dense model and of reduced paligemma-3b
match 1 x 1 and the reference's jitted step: losses and gradient norms
within 1e-4 relative, the params after the last step within rtol 1e-3 /
atol 1e-5 (the reference's own microbatch test, `tests/test_steps_system.py`)
on (2, 1), (1, 2), (2, 2), (4, 1), (1, 4) (the kv heads the model axis does
not divide) and a (2, 2, 1) pod mesh, with and without `grad_compress` and
`microbatch=2`; the only elements let off are those the reference's own
gradients show Adam's update ill-conditioned on (`_ill_conditioned`).
Masks that differ between the data ranks give the one-device loss; a
batch the data axis does not divide is counted once; the placement holds
exactly the whole state's bytes; a placed 1 x 1 step is the plain step's
bits; the trainer runs and resumes on a mesh. The MoE, recurrent, hybrid
and audio families' mesh steps are `test_torch_train_mesh_moe.py`'s and
`test_torch_train_mesh_slot.py`'s."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.distributed import sharding as ref_sharding
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import config as ref_config
from repro.models.registry import get_model as ref_get_model
from repro.models.registry import lm_loss as ref_lm_loss
from repro.optim import compress as ref_compress
from repro.optim import optimizer as ref_opt
from repro_torch.distributed import placement, sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps as port_steps
from repro_torch.launch.train import train
from repro_torch.models import config as port_config
from repro_torch.models.registry import get_model, lm_loss
from repro_torch.optim import compress as port_compress
from repro_torch.optim import optimizer as port_opt
from repro_torch.tree import flatten_with_paths, leaves

from _xfw import np_of

pytestmark = pytest.mark.tier1

CPU = torch.device("cpu")
TINY = dict(arch_id="steps-tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, dtype="float32")
SPEC_MESHES = {"1x1": {"data": 1, "model": 1}, "1x8": {"data": 1, "model": 8},
               "2x4": {"data": 2, "model": 4}, "8x1": {"data": 8, "model": 1},
               "pod_2x16x16": {"pod": 2, "data": 16, "model": 16}}
MESHES = [(2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (2, 2, 1)]
STEPS, REL, RTOL, ATOL = 3, 1e-4, 1e-3, 1e-5
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
# Adam's update g / (sqrt(v) + eps) is ill-conditioned on an element whose
# gradient is non-zero and within K_EPS eps of zero, and (grad_compress) on
# one whose int8 quotient (g + r) / scale lies within BOUNDARY of a .5
# rounding boundary: an f32 difference in such a gradient moves its update
# by a visible part of lr (a code flip moves it by one scale)
K_EPS, BOUNDARY = 100, 1e-3
ARCHS = port_config.list_archs()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread for the module, its shared runs too: the
    steps here are thousands of small ops, and with the suite's workers
    sharing the cores each parallel region waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return port_mesh.make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


def _bundle(model, mesh, batch, seq, **kw):
    with sharding.use_rules(mesh):
        return port_steps.build_train_step(
            model, port_config.ShapeConfig("t", seq, batch, "train"),
            port_opt.OptConfig(**OPT), **kw)


def _port_run(model, params, batches, mesh, grad_compress=False, microbatch=0):
    """STEPS steps on `mesh` (plain tensors at None): (losses, grad norms,
    whole params after)."""
    b0 = batches[0]["tokens"]
    bundle = _bundle(model, mesh or _mesh((1, 1)), b0.shape[0], b0.shape[1],
                     grad_compress=grad_compress, microbatch=microbatch)
    p, o = params, port_opt.init_adam(params)
    e = port_compress.init_ef(params) if grad_compress else port_compress.EFState(None)
    if mesh is not None:
        p, o, e = port_steps.place_train_state(bundle, mesh, p, o, e)
    losses, gnorms = [], []
    for b in batches:
        p, o, e, m = bundle(p, o, e, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms, (p.whole() if mesh is not None else p)


_REF_GRADS = {}


def _ref_grad(rmodel):
    """The reference bundle's objective (lm_loss + 0.01 aux) differentiated
    and jitted, once a model."""
    if id(rmodel) not in _REF_GRADS:
        def objective(p, b):
            logits, aux = rmodel.apply(p, b)
            return ref_lm_loss(logits, b["targets"], b["loss_mask"], rmodel.cfg.vocab) \
                + 0.01 * aux
        _REF_GRADS[id(rmodel)] = (rmodel, jax.jit(
            jax.grad(objective), compiler_options={"xla_backend_optimization_level": 0}))
    return _REF_GRADS[id(rmodel)][1]


def _ill_conditioned(g, r):
    """The elements of one leaf Adam's update is ill-conditioned on at a
    step, from the reference's gradient `g` and (grad_compress) its EF
    residual `r` before the step (see K_EPS, BOUNDARY)."""
    g = np.asarray(g, np.float32)
    ill = (g != 0) & (np.abs(g) < K_EPS * ref_opt.OptConfig().eps)
    if r is not None:
        gf = g + np.asarray(r)
        q = gf / (max(float(np.abs(gf).max()), 1e-30) / 127.0)
        ill |= np.abs(q - np.floor(q) - 0.5) < BOUNDARY
    return ill


def _ref_run(rmodel, params, batches, grad_compress=False, microbatch=0):
    """The reference's jitted step, once a batch, on its one CPU device,
    compiled at XLA's backend optimization level 0 (half the compile time
    of the default; the same losses): (losses, gradient norms, params
    after, a mask a param leaf of the elements `_ill_conditioned` at some
    step of the run, from the reference's gradient of the whole batch)."""
    b0 = batches[0]["tokens"]
    grad = _ref_grad(rmodel)
    with ref_sharding.use_rules(ref_host_mesh()):
        b = ref_steps.build_train_step(
            rmodel, ref_config.ShapeConfig("t", b0.shape[1], b0.shape[0], "train"),
            ref_opt.OptConfig(**OPT), grad_compress=grad_compress, microbatch=microbatch)
        fn = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings,
                     compiler_options={"xla_backend_optimization_level": 0})
        # the state committed to the step's shardings, as its outputs are, so
        # that the second step does not compile the step and the gradient again
        p, o, e = jax.device_put(
            (params, ref_opt.init_adam(params),
             ref_compress.init_ef(params) if grad_compress else ref_compress.EFState(None)),
            b.in_shardings[:3])
        losses, gnorms, ill = [], [], None
        for bt in batches:
            jb = {k: jnp.asarray(np_of(v)) for k, v in bt.items()}
            res = leaves(e.residual) if grad_compress else None
            now = [_ill_conditioned(g, None if res is None else res[i])
                   for i, g in enumerate(leaves(grad(p, jb)))]
            ill = now if ill is None else [a | c for a, c in zip(ill, now)]
            p, o, e, m = fn(p, o, e, jb)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    return losses, gnorms, p, ill


def _assert_match(got, want, what, ill=None):
    """Losses and gradient norms within REL; every param within RTOL /
    ATOL, but the elements of `ill` (the reference run's
    `_ill_conditioned` mask; None: none), which are held to the span of the
    run's Adam steps, 2 · lr a step."""
    for name, g, w in zip(("loss", "grad_norm"), got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=REL, atol=0, err_msg=f"{what} {name}")
    # a dict of tensors or of jax arrays: both flatten with sorted keys
    gp, wp = flatten_with_paths(got[2]), leaves(want[2])
    assert len(gp) == len(wp)
    for i, ((path, g), w) in enumerate(zip(gp, wp)):
        g, w = np_of(g), np_of(w)
        off = np.abs(g - w) > ATOL + RTOL * np.abs(w)
        if ill is not None:
            assert (np.abs(g - w)[off] <= len(got[0]) * 2 * OPT["lr"]).all(), (what, path)
            off &= ~ill[i]
        assert not off.any(), (what, path, np.argwhere(off)[:4].tolist())


def _params_pair(model, seed):
    """(the reference's tree, the port's tree) of the same params, drawn
    once (the port's init from `seed`; no reference init to compile)."""
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")

    def ref(tree):
        return {k: ref(v) for k, v in tree.items()} if isinstance(tree, dict) else \
            jnp.asarray(tree.numpy())
    return ref(params), params


@pytest.fixture(scope="module")
def tiny():
    rmodel = ref_get_model(ref_config.ModelConfig(**TINY))
    model = get_model(port_config.ModelConfig(**TINY))
    rparams, params = _params_pair(model, 0)
    data = RefSyntheticLM(RefDataConfig(vocab=256, seq_len=32, batch_size=8))
    batches = [{k: torch.from_numpy(v) for k, v in data.batch(s).items()} for s in range(STEPS)]
    return rmodel, model, rparams, params, batches


@pytest.fixture(scope="module")
def tiny_runs(tiny):
    """{variant: (the reference's run, the port's 1 x 1 run)}."""
    rmodel, model, rparams, params, batches = tiny
    out = {}
    for name, kw in (("plain", {}), ("grad_compress", dict(grad_compress=True)),
                     ("microbatch", dict(microbatch=2))):
        out[name] = (_ref_run(rmodel, rparams, batches, **kw),
                     _port_run(model, params, batches, None, **kw))
    return out


# ---------------------------------------------------------------------------
# the bundle's specs
# ---------------------------------------------------------------------------

@pytest.fixture
def ref_specs_only(monkeypatch):
    """The reference's NamedSharding as its spec: a stand-in mesh has no
    devices to build one over."""
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.usefixtures("ref_specs_only")
@pytest.mark.parametrize("arch", ARCHS)
def test_training_specs_equal_the_reference(arch):
    """in_shardings (params, Adam count / m / v, EF residuals, batch) and
    out_shardings of the train bundle, leaf by leaf with their paths, equal
    the reference's on every stand-in mesh shape; the abstract inputs have
    its shapes, on "meta"."""
    port = get_model(port_config.reduced(port_config.get_config(arch)))
    ref = ref_get_model(ref_config.reduced(ref_config.get_config(arch)))
    n_leaves = 0
    for shape in SPEC_MESHES.values():
        mesh = types.SimpleNamespace(shape=dict(shape))
        with ref_sharding.use_rules(mesh):
            want = ref_steps.build_train_step(ref, ref_config.ShapeConfig("t", 64, 32, "train"),
                                              grad_compress=True)
        with sharding.use_rules(mesh):
            got = port_steps.build_train_step(port, port_config.ShapeConfig("t", 64, 32, "train"),
                                              grad_compress=True)
        for g_tree, w_tree in ((got.in_shardings, want.in_shardings),
                               (got.out_shardings, want.out_shardings)):
            g = [(p, tuple(s.spec)) for p, s in flatten_with_paths(
                g_tree, is_leaf=lambda x: isinstance(x, sharding.NamedSharding))]
            w = [(jax.tree_util.keystr(p), tuple(s)) for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     w_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]]
            assert g == w, (arch, shape)
            n_leaves += len(g)
        got_shapes = [tuple(x.shape) for x in leaves(got.abstract_inputs)]
        assert got_shapes == [tuple(x.shape) for x in jax.tree_util.tree_leaves(
            want.abstract_inputs)]
        assert all(x.device.type == "meta" for x in leaves(got.abstract_inputs))
    assert n_leaves > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_takes_a_train_step_on_a_mesh(arch):
    """Every registered arch at `reduced()` builds, places and runs one
    train step on (2, 1) and (1, 2) of a repeated CPU device, its loss and
    gradient norm within REL of 1 x 1's (frames and images from a seed
    where `input_specs` asks for them)."""
    model = get_model(port_config.reduced(port_config.get_config(arch)))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batch = {}
    for k, spec in port_config.input_specs(
            model.cfg, port_config.ShapeConfig("t", 16, 4, "train")).items():
        if k in ("tokens", "targets"):
            x = rng.integers(0, model.cfg.vocab, tuple(spec.shape)).astype(np.int32)
        elif k == "loss_mask":
            x = np.ones(tuple(spec.shape), np.float32)
        else:
            x = rng.standard_normal(tuple(spec.shape)).astype(np.float32)
        batch[k] = torch.from_numpy(x).to(spec.dtype)
    want = _port_run(model, params, [batch], None)
    for shape in ((2, 1), (1, 2)):
        got = _port_run(model, params, [batch], _mesh(shape))
        np.testing.assert_allclose(got[0], want[0], rtol=REL, err_msg=f"{arch} {shape} loss")
        np.testing.assert_allclose(got[1], want[1], rtol=REL, err_msg=f"{arch} {shape} gnorm")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 1)], ids=str)
def test_fsdp_placement_gives_each_rank_its_part_and_holds_the_state_once(shape, tiny):
    """Each data rank's part of a data-cut leaf is a tensor of its own (the
    (pod, data) compound axis in row-major rank order), a leaf no rule cuts
    is one shared tensor, the distinct tensors hold exactly the whole
    state's bytes, `whole` gives the leaves back bit for bit and
    `cut_like` cuts them again as placed; a serving placement of the same
    specs still refuses the data cut."""
    _, model, _, params, _ = tiny
    mesh = _mesh(shape)
    bundle = _bundle(model, mesh, 8, 32)
    opt = port_opt.init_adam(params)
    p, o, _ = port_steps.place_train_state(bundle, mesh, params, opt)
    n_ranks = len(p.views)
    assert n_ranks == int(np.prod(shape[:-1]))
    # embed (vocab, d_model): vocab on "model", d_model on the data axes
    embed = [list(e.parts) if isinstance(e, sharding.Sharded) else [e]
             for e in (v["embed"] for v in p.views)]
    assert len({id(t) for e in embed for t in e}) == n_ranks * shape[-1]
    for r, e in enumerate(embed):
        cols = params["embed"].shape[1] // n_ranks
        assert torch.equal(torch.cat(e, 0), params["embed"][:, r * cols:(r + 1) * cols])
    scale = [v["blocks"]["ln_attn"]["scale"] for v in p.views]
    assert all(s is scale[0] for s in scale)
    whole_bytes = sum(t.numel() * t.element_size() for t in leaves(params) + leaves(opt))
    assert sum(t.numel() * t.element_size() for t in p.parts() + o.parts()) == whole_bytes
    for a, b in zip(leaves(p.whole()), leaves(params)):
        assert torch.equal(a, b)
    again = placement.cut_like(p.whole(), p)
    assert all(torch.equal(a, b) for a, b in zip(again.parts(), p.parts()))
    with pytest.raises(NotImplementedError, match="only the model axis"):
        placement.place(params, bundle.in_shardings[0], mesh)


# ---------------------------------------------------------------------------
# the mesh step against 1 x 1 and the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "grad_compress", "microbatch"])
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_mesh_steps_match_one_by_one_and_the_reference(shape, variant, tiny, tiny_runs):
    _, model, _, params, batches = tiny
    kw = {"plain": {}, "grad_compress": dict(grad_compress=True),
          "microbatch": dict(microbatch=2)}[variant]
    got = _port_run(model, params, batches, _mesh(shape), **kw)
    want_ref, want_port = tiny_runs[variant]
    _assert_match(got, want_port, f"{shape} {variant} vs 1x1", want_ref[3])
    _assert_match(got, want_ref, f"{shape} {variant} vs the reference", want_ref[3])


@pytest.fixture(scope="module")
def paligemma():
    """Reduced paligemma-3b, its batches (an image prefix of patch
    embeddings), the port's 1 x 1 run and the reference's run."""
    rmodel = ref_get_model(ref_config.reduced(ref_config.get_config("paligemma-3b")))
    model = get_model(port_config.reduced(port_config.get_config("paligemma-3b")))
    rparams, params = _params_pair(model, 1)
    data = RefSyntheticLM(RefDataConfig(vocab=model.cfg.vocab, seq_len=16, batch_size=4))
    rng = np.random.default_rng(3)
    batches = []
    for s in range(STEPS):
        b = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        b["img_embeds"] = torch.from_numpy(rng.normal(
            size=(4, model.cfg.n_img_tokens, model.cfg.d_model)).astype(np.float32))
        batches.append(b)
    return (model, params, batches, _port_run(model, params, batches, None),
            _ref_run(rmodel, rparams, batches), rmodel, rparams)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_paligemma_mesh_steps_match_one_by_one_and_the_reference(shape, paligemma):
    """Reduced paligemma-3b (the vlm family: an image prefix of patch
    embeddings, 16 padded query heads over 1 kv head, so a model axis of 2
    attends whole), STEPS steps against 1 x 1 and the reference."""
    model, params, batches, want_port, want_ref, _, _ = paligemma
    got = _port_run(model, params, batches, _mesh(shape))
    _assert_match(got, want_port, f"paligemma {shape} vs 1x1", want_ref[3])
    _assert_match(got, want_ref, f"paligemma {shape} vs reference", want_ref[3])


def test_a_larger_eps_leaves_no_element_to_let_off(paligemma, monkeypatch):
    """The witness of `_ill_conditioned`'s first rule: with Adam's eps
    raised from 1e-8 to 1e-5 in both packages, so that no gradient of the
    run is within a few eps of zero where it is not zero, the (2, 1) mesh's
    3 steps match the reference's with no element let off."""
    model, params, batches, _, _, rmodel, rparams = paligemma
    monkeypatch.setitem(OPT, "eps", 1e-5)
    _assert_match(_port_run(model, params, batches, _mesh((2, 1))),
                  _ref_run(rmodel, rparams, batches), "paligemma (2, 1) at eps 1e-5")


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)], ids=str)
def test_masks_that_differ_between_data_ranks_give_the_one_device_loss(shape, tiny):
    """Rank 0's rows mostly masked, the others' not: each data rank's NLL
    sum over the GLOBAL mask count gives the one-device loss and step (a
    mean of per-rank means would be another number)."""
    _, model, _, params, batches = tiny
    rng = np.random.default_rng(7)
    masked = []
    for b in batches:
        mask = np.ones((8, 32), np.float32)
        mask[:2] = (rng.random((2, 32)) > 0.8)
        mask[2:] = (rng.random((6, 32)) > 0.1)
        masked.append({**b, "loss_mask": torch.from_numpy(mask)})
    got = _port_run(model, params, masked, _mesh(shape))
    want = _port_run(model, params, masked, None)
    _assert_match(got, want, f"{shape} uneven masks")
    n = shape[0]
    logits, _ = model.apply(params, masked[0])
    per_rank = [float(lm_loss(logits[i * 8 // n:(i + 1) * 8 // n],
                              masked[0]["targets"][i * 8 // n:(i + 1) * 8 // n],
                              masked[0]["loss_mask"][i * 8 // n:(i + 1) * 8 // n], 256))
                for i in range(n)]
    assert abs(np.mean(per_rank) / want[0][0] - 1) > 1e-3


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2, 1)], ids=str)
def test_a_batch_the_data_axis_does_not_divide_is_counted_once(shape, tiny):
    """3 rows on 2 or 4 data ranks: the rules leave the batch whole, the
    step computes it once and counts its gradient once (the gradient norm
    and the update are 1 x 1's, not n times them); on the (2, 2, 1) pod
    mesh 2 rows cut on data alone, every pod rank holding the same rows."""
    _, model, _, params, batches = tiny
    rows = 2 if len(shape) == 3 else 3
    mesh = _mesh(shape)
    want_rows = [(0, 1), (1, 2)] if len(shape) == 3 else [(0, 3)]
    assert port_steps.train_rows(mesh, rows) == want_rows
    cut = [{k: v[:rows] for k, v in b.items()} for b in batches]
    _assert_match(_port_run(model, params, cut, mesh), _port_run(model, params, cut, None),
                  f"{shape} {rows} rows")


def test_a_placed_one_by_one_step_is_the_plain_steps_bits(tiny):
    """On a 1 x 1 mesh the placed state's step (the mesh step, one data
    rank, no cut) gives the plain step's bits: loss, gradient norm, every
    param and moment."""
    _, model, _, params, batches = tiny
    mesh = _mesh((1, 1))
    bundle = _bundle(model, mesh, 8, 32)
    plain = (params, port_opt.init_adam(params), port_compress.EFState(None))
    placed = port_steps.place_train_state(bundle, mesh, params, port_opt.init_adam(params))
    for b in batches:
        *plain, mp = bundle(*plain, b)
        *placed, mq = bundle(*placed, b)
        for k in ("loss", "aux", "grad_norm"):
            assert torch.equal(mp[k], mq[k]), k
    for a, b in zip(leaves((plain[0], plain[1])), leaves((placed[0].whole(), placed[1].whole()))):
        assert torch.equal(a, b)


def test_the_trainer_runs_and_resumes_on_a_mesh(tmp_path):
    """`train(mesh=)`: 6 steps of reduced qwen2-1.5b on (2, 1) give the 1 x 1
    losses, checkpointing at steps 4 and 6; with step 6's checkpoint gone
    (a crash before it committed), a run on (1, 2) resumes at step 4, the
    state restored onto its own mesh, and ends on the same losses."""
    import shutil
    kw = dict(steps=6, batch=4, seq=16, use_reduced=True, log_every=1000, device="cpu")
    want = train("qwen2-1.5b", **kw)
    d = str(tmp_path / "ck")
    got = train("qwen2-1.5b", mesh=_mesh((2, 1)), ckpt_dir=d, ckpt_every=4, **kw)
    np.testing.assert_allclose(got.losses, want.losses, rtol=REL)
    shutil.rmtree(tmp_path / "ck" / "step_00000006")
    rep = train("qwen2-1.5b", mesh=_mesh((1, 2)), ckpt_dir=d, ckpt_every=4, **kw)
    assert rep.resumed_from == 4 and rep.steps_run == 2
    np.testing.assert_allclose(rep.losses, want.losses[4:], rtol=REL)
