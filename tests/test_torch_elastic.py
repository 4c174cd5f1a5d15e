"""The elastic restart (`launch/elastic.py`) and the checkpoint of a placed
training state against the JAX package's.

`simulate_failure_and_resume` on the tiny dense model of
`tests/test_steps_system.py` and its `SyntheticLM` stream, from the
reference's initial params: the port over `[cpu] x n` at (4, 1) -> (2, 1),
(2, 2) -> (1, 2) and (2, 1) -> (1, 1) against the reference's run on its one
device: the same resumed step, losses before and after within 1e-4
relative, the reference's own checks (`tests/test_steps_system.py:75-86`),
every restored leaf bit-equal to the one saved. A checkpoint saved from a
placed tree restores in the reference's `CheckpointManager` bit-equal, and
the reference's restores onto a port mesh bit-equal, each rank holding its
part. `make_elastic_mesh`'s shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch import elastic as ref_elastic
from repro.launch import mesh as ref_mesh
from repro.models import config as ref_config
from repro.models.registry import get_model as ref_get_model
from repro.optim import optimizer as ref_opt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import from_reference
from repro_torch.distributed import placement, sharding
from repro_torch.launch import elastic
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps as port_steps
from repro_torch.models import config as port_config
from repro_torch.models.registry import Model, get_model
from repro_torch.optim import optimizer as port_opt
from repro_torch.tree import leaves

from _xfw import np_of, to_numpy_tree

pytestmark = pytest.mark.tier1

CPU = torch.device("cpu")
TINY = dict(arch_id="steps-tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, dtype="float32")
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread for the module, its shared runs too: the
    steps here are thousands of small ops, and with the suite's workers
    sharing the cores each parallel region waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(reference model, port model, reference params, port params, the
    stream, the reference's elastic report)."""
    rmodel = ref_get_model(ref_config.ModelConfig(**TINY))
    model = get_model(port_config.ModelConfig(**TINY))
    data = RefSyntheticLM(RefDataConfig(vocab=256, seq_len=64, batch_size=8))
    rparams = rmodel.init(jax.random.key(0))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        rep = ref_elastic.simulate_failure_and_resume(
            rmodel, d, data_fn=lambda s: {k: jnp.asarray(v) for k, v in data.batch(s).items()},
            steps_each=5)
    return (rmodel, model, rparams, from_reference(to_numpy_tree(rparams), device="cpu"),
            data, rep)


@pytest.mark.parametrize("n, mp", [(4, 1), (4, 2), (2, 1)], ids=["4x1", "2x2", "2x1"])
def test_failure_and_resume_equal_the_reference(n, mp, tiny, tmp_path, monkeypatch):
    """The port's model.init stands in with the reference's initial params
    (`jax.random.key(0)`, converted), so both runs start from one tree."""
    _, model, _, params, data, want = tiny
    monkeypatch.setattr(Model, "init", lambda self, generator, device="cuda": params)
    rep = elastic.simulate_failure_and_resume(
        model, str(tmp_path / "el"), steps_each=5, devices=[CPU] * n, model_parallel=mp,
        data_fn=lambda s: {k: torch.from_numpy(v) for k, v in data.batch(s).items()})
    assert rep.resumed_step == want.resumed_step == 5
    assert rep.steps_before == rep.steps_after == 5
    assert rep.loss_before == pytest.approx(want.loss_before, rel=REL)
    assert rep.loss_after == pytest.approx(want.loss_after, rel=REL)
    assert np.isfinite(rep.loss_after) and rep.loss_after < rep.loss_before + 0.5
    assert rep.restored_equal is True
    assert rep.mesh_before == {"data": n // mp, "model": mp}
    assert rep.mesh_after == {"data": max(n // 2 // mp, 1), "model": mp}


def _placed_state(model, params, shape):
    mesh = port_mesh.make_mesh(shape, ("data", "model"), [CPU] * int(np.prod(shape)))
    with sharding.use_rules(mesh):
        bundle = port_steps.build_train_step(model, port_config.ShapeConfig("t", 32, 8, "train"))
    opt = port_opt.init_adam(params)
    # moments that are not zeros: one Adam update on a made-up gradient
    _, opt, _ = port_opt.adam_update(port_opt.OptConfig(), params,
                                     {k: v for k, v in params.items()}, opt)
    p, o, _ = port_steps.place_train_state(bundle, mesh, params, opt)
    return mesh, bundle, p, o


def test_a_placed_checkpoint_restores_in_the_reference_bit_equal(tiny, tmp_path):
    rmodel, model, _, params, _, _ = tiny
    _, _, p, o = _placed_state(model, params, (2, 2))
    CheckpointManager(str(tmp_path)).save(3, {"params": p, "opt": o})
    like = {"params": rmodel.abstract(), "opt": ref_opt.abstract_adam(rmodel.abstract())}
    got = RefCheckpointManager(str(tmp_path)).restore(3, like)
    want = leaves({"params": p.whole(), "opt": o.whole()})
    got = jax.tree_util.tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np_of(w))


def test_the_references_checkpoint_restores_onto_a_port_mesh(tiny, tmp_path):
    """Restored with the (2, 2) bundle's shardings: a MeshTree whose whole
    leaves are the reference's bits and whose parts are their cuts."""
    _, model, rparams, params, _, _ = tiny
    ropt = ref_opt.init_adam(rparams)
    ropt = ropt._replace(step=jnp.asarray(7, jnp.int32),
                         m=jax.tree_util.tree_map(lambda x: x * 0.5, rparams))
    RefCheckpointManager(str(tmp_path)).save(7, {"params": rparams, "opt": ropt})
    mesh, bundle, p, o = _placed_state(model, params, (2, 2))
    cm = CheckpointManager(str(tmp_path))
    step, state = cm.restore_latest(
        {"params": bundle.abstract_inputs[0], "opt": bundle.abstract_inputs[1]},
        shardings={"params": bundle.in_shardings[0], "opt": bundle.in_shardings[1]})
    assert step == 7 and isinstance(state, placement.MeshTree)
    got_p, got_o = state["params"], state["opt"]
    for g, w in zip(leaves(got_p.whole()) + leaves(got_o.whole()),
                    jax.tree_util.tree_leaves((rparams, ropt))):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))
    assert int(got_o.views[1].step) == 7
    again = placement.cut_like(got_p.whole(), p)
    assert all(torch.equal(a, b) for a, b in zip(again.parts(), got_p.parts()))
    assert len(got_p.parts()) == len(p.parts())


@pytest.mark.parametrize("n, mp, per_pod, want", [
    (1, 1, 1, {"data": 1, "model": 1}), (4, 1, 4, {"data": 4, "model": 1}),
    (2, 1, 4, {"data": 2, "model": 1}), (4, 2, 4, {"data": 2, "model": 2}),
    (2, 2, 4, {"data": 1, "model": 2}), (8, 2, 4, {"pod": 2, "data": 2, "model": 2}),
    (12, 1, 4, {"pod": 3, "data": 4, "model": 1})])
def test_make_elastic_mesh_shapes(n, mp, per_pod, want):
    """The model axis kept, the rest given to (pod, data); at one chip the
    reference's own mesh."""
    got = port_mesh.make_elastic_mesh(n, model_parallel=mp, chips_per_pod=per_pod,
                                      devices=[CPU] * n)
    assert got.shape == want and got.size == n
    if n == 1:
        assert got.shape == dict(ref_mesh.make_elastic_mesh(1, model_parallel=1,
                                                            chips_per_pod=1).shape)
