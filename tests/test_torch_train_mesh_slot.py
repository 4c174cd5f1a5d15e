"""Training the recurrent, hybrid and audio families on a (data, model)
mesh: reduced rwkv6-1.6b, gla-1.3b, zamba2-1.2b (2 layers: one application
of the shared attention block) and whisper-large-v3 (2 encoder + 2 decoder
layers, 16 padded heads, frames from a seed), against the port's own
one-device step and the JAX package's jitted step.

Each data rank runs the forward of its rows (whisper: its frames through
the encoder, its own cross K / V); each model rank runs the mixers of the
full-sequence forward over its heads (`slot_state.per_head_ranks`): the
WKV / GLA / SSD chunked forms and zamba2's causal conv (by inner
channels), whisper's attention in both stacks, each rank from its slice of
the zero state. On (2, 1) and (1, 2) two steps equal 1 x 1 and the
reference (losses and gradient norms rel 1e-4, params rtol 1e-3 / atol
1e-5 but the elements `_ill_conditioned` lets off); on (1, 2) each mixer
runs once per model rank over half the heads; masks that differ between
the data ranks give the one-device loss; `train(mesh=)` runs rwkv6 on
(2, 1), checkpoints and resumes on (1, 2); whisper's encoder tables restore
from (2, 2) onto (1, 2)."""
import shutil

import numpy as np
import pytest
import torch

from repro.models import config as ref_config
from repro.models.registry import get_model as ref_get_model
from repro_torch.launch import elastic
from repro_torch.launch import steps as port_steps
from repro_torch.launch.train import train
from repro_torch.models import config as port_config
from repro_torch.models import gla, rwkv6, whisper, zamba2
from repro_torch.models.registry import get_model
from repro_torch.optim import optimizer as port_opt

from test_torch_train_mesh import (REL, _assert_match, _bundle, _mesh, _params_pair,
                                   _port_run, _ref_run)

pytestmark = pytest.mark.tier1

ARCHS = ["rwkv6-1.6b", "gla-1.3b", "zamba2-1.2b", "whisper-large-v3"]
B, S, N_STEPS = 4, 16, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread for the module (see
    `test_torch_train_mesh.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(cfg, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
             for k in ("tokens", "targets")}
        b["loss_mask"] = torch.ones(B, S)
        if cfg.enc_seq:
            b["frames"] = torch.from_numpy(
                rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        out.append(b)
    return out


def _port_model(arch):
    return get_model(port_config.reduced(port_config.get_config(arch), n_layers=2))


@pytest.fixture(scope="module", params=ARCHS)
def slot(request):
    """(arch, model, params, batches, the port's 1 x 1 run, the reference's
    run)."""
    arch = request.param
    rmodel = ref_get_model(ref_config.reduced(ref_config.get_config(arch), n_layers=2))
    model = _port_model(arch)
    rparams, params = _params_pair(model, 0)
    batches = _batches(model.cfg, 13)
    return (arch, model, params, batches, _port_run(model, params, batches, None),
            _ref_run(rmodel, rparams, batches))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=str)
def test_mesh_steps_match_one_by_one_and_the_reference(shape, slot):
    arch, model, params, batches, want_port, want_ref = slot
    got = _port_run(model, params, batches, _mesh(shape))
    _assert_match(got, want_port, f"{arch} {shape} vs 1x1", want_ref[3])
    _assert_match(got, want_ref, f"{arch} {shape} vs the reference", want_ref[3])


# per arch: (module, the mixer's name there, what its first argument's dim
# counts: heads on dim 2, or zamba2's conv channels on dim -1)
MIXERS = {
    "rwkv6-1.6b": [(rwkv6, "wkv6_chunked", 2)],
    "gla-1.3b": [(gla, "gla_chunked", 2)],
    "zamba2-1.2b": [(zamba2, "ssd_chunked", 2), (zamba2, "_causal_conv", -1)],
    "whisper-large-v3": [(whisper, "attention", 2)],
}


@pytest.mark.parametrize("arch", ARCHS)
def test_each_model_rank_runs_the_mixer_over_its_heads(arch, monkeypatch):
    """The full-sequence forward of a (1, 2) step's compute layout calls
    each mixer twice as often as 1 x 1, each call over half the heads (or
    inner channels), from its slice of the zero state; 1 x 1 calls it with
    every head."""
    model = _port_model(arch)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batches(model.cfg, 3)[0]
    seen = {}
    for module, name, dim in MIXERS[arch]:
        def counted(*args, _fn=getattr(module, name), _key=name, _dim=dim, **kw):
            seen.setdefault(_key, []).append(args[0].shape[_dim])
            return _fn(*args, **kw)
        monkeypatch.setattr(module, name, counted)

    def calls(mesh):
        seen.clear()
        state = params
        if mesh is not None:
            bundle = _bundle(model, mesh, B, S)
            state = port_steps.place_train_state(bundle, mesh, params,
                                                 port_opt.init_adam(params))[0]
        whole, _, compute = port_steps._mesh_layout(model, state)
        with torch.no_grad():
            model.apply(compute(whole), batch)
        return dict(seen)

    one, two = calls(None), calls(_mesh((1, 2)))
    assert set(one) == {name for _, name, _ in MIXERS[arch]}
    for name, widths in one.items():
        assert len(two[name]) == 2 * len(widths), name
        assert two[name] == [w // 2 for w in widths for _ in range(2)], (name, two[name])


def test_masks_that_differ_between_data_ranks_give_the_one_device_loss():
    """rwkv6 on (2, 1): rank 0's rows mostly masked, rank 1's not."""
    model = _port_model("rwkv6-1.6b")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(9)
    masked = []
    for b in _batches(model.cfg, 4):
        mask = np.ones((B, S), np.float32)
        mask[:B // 2] = rng.random((B // 2, S)) > 0.8
        mask[B // 2:] = rng.random((B // 2, S)) > 0.1
        masked.append({**b, "loss_mask": torch.from_numpy(mask)})
    _assert_match(_port_run(model, params, masked, _mesh((2, 1))),
                  _port_run(model, params, masked, None), "rwkv6 (2, 1) uneven masks")


def test_the_trainer_runs_and_resumes_rwkv6_on_a_mesh(tmp_path):
    """`train(mesh=)`: 4 steps of reduced rwkv6-1.6b on (2, 1) give the
    1 x 1 losses, checkpointing at steps 2 and 4; with step 4's checkpoint
    gone, a run on (1, 2) resumes at step 2 onto its own mesh and ends on
    the same losses."""
    kw = dict(steps=4, batch=4, seq=16, use_reduced=True, log_every=1000, device="cpu")
    want = train("rwkv6-1.6b", **kw)
    d = str(tmp_path / "ck")
    got = train("rwkv6-1.6b", mesh=_mesh((2, 1)), ckpt_dir=d, ckpt_every=2, **kw)
    np.testing.assert_allclose(got.losses, want.losses, rtol=REL)
    shutil.rmtree(tmp_path / "ck" / "step_00000004")
    rep = train("rwkv6-1.6b", mesh=_mesh((1, 2)), ckpt_dir=d, ckpt_every=2, **kw)
    assert rep.resumed_from == 2 and rep.steps_run == 2
    np.testing.assert_allclose(rep.losses, want.losses[2:], rtol=REL)


def test_whisper_restores_onto_another_mesh(tmp_path):
    """The elastic restart of reduced whisper from (2, 2) to (1, 2): the
    encoder's and decoder's tables and Adam's moments restore bit-equal
    and training goes on, each step's frames with its tokens."""
    model = _port_model("whisper-large-v3")
    batches = _batches(model.cfg, 21)
    rep = elastic.simulate_failure_and_resume(
        model, str(tmp_path / "ck"), data_fn=lambda s: batches[s % N_STEPS], steps_each=2,
        batch=B, seq=S, devices=[torch.device("cpu")] * 4, model_parallel=2)
    assert rep.mesh_after == {"data": 1, "model": 2}
    assert rep.restored_equal and rep.resumed_step == 2
    assert np.isfinite(rep.loss_after)
