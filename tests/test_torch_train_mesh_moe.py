"""Training the MoE family on a (data, model) mesh: reduced phi3.5-moe
(top-2) and llama4-scout (top-1, 16 padded query heads), 2 layers, against
the port's own one-device step and the JAX package's jitted step.

An MoE step runs every data rank's rows as one range (`launch/steps.py
_mesh_layout`), so a step's tokens are routed once, as the reference's one
program routes them. The batches here tell
that apart from routing each data rank's rows alone: a data rank of (2, 1)
holds 32 tokens, fewer than the whole set's group of 64, and its rows
repeat one token, which piles them on one expert past its capacity, so the
per-rank groups drop other tokens and give another loss (checked). On
(2, 1), (1, 2) and (2, 2) two steps equal 1 x 1 and the reference (losses
and gradient norms rel 1e-4, params rtol 1e-3 / atol 1e-5 but the elements
`_ill_conditioned` lets off); the reported aux is the whole token set's,
not a mean of per-rank auxes; `microbatch=2` reports aux 0; `grad_compress`
on (2, 2); masks that differ between the data ranks; a checkpoint of the
expert stacks saved on (2, 2) and restored onto (1, 2)."""
import numpy as np
import pytest
import torch

from repro.models import config as ref_config
from repro.models.registry import get_model as ref_get_model
from repro_torch.launch import elastic
from repro_torch.launch import steps as port_steps
from repro_torch.models import config as port_config
from repro_torch.models.registry import get_model, lm_loss, lm_nll
from repro_torch.optim import compress as port_compress
from repro_torch.optim import optimizer as port_opt

from test_torch_train_mesh import (REL, _assert_match, _bundle, _mesh, _params_pair,
                                   _port_run, _ref_run)

pytestmark = pytest.mark.tier1

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
B, S, N_STEPS = 4, 16, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch on one intra-op thread for the module (see
    `test_torch_train_mesh.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _separating_batches(vocab: int, seed: int):
    """N_STEPS batches of B x S whose first half of the rows (data rank 0's
    on (2, 1)) repeats one token, the rest random: identical tokens have
    identical hidden rows and pick one expert first."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
        tokens[:B // 2] = rng.integers(0, vocab)
        targets = rng.integers(0, vocab, (B, S)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets),
                    "loss_mask": torch.ones(B, S)})
    return out


def _models(arch):
    rmodel = ref_get_model(ref_config.reduced(ref_config.get_config(arch), n_layers=2))
    model = get_model(port_config.reduced(port_config.get_config(arch), n_layers=2))
    return rmodel, model


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe(request):
    """(arch, model, params, batches, the port's 1 x 1 run, the reference's
    run, the reference model, its params)."""
    rmodel, model = _models(request.param)
    rparams, params = _params_pair(model, 0)
    batches = _separating_batches(model.cfg.vocab, 11)
    return (request.param, model, params, batches, _port_run(model, params, batches, None),
            _ref_run(rmodel, rparams, batches), rmodel, rparams)


def _step(model, params, batch, mesh, **kw):
    """One train step from `params` on `mesh` (plain tensors at None): its
    metrics."""
    bundle = _bundle(model, mesh or _mesh((1, 1)), batch["tokens"].shape[0],
                     batch["tokens"].shape[1], **kw)
    state = (params, port_opt.init_adam(params), port_compress.EFState(None))
    if mesh is not None:
        state = port_steps.place_train_state(bundle, mesh, *state)
    return bundle(*state, batch)[3]


def _per_rank(model, params, batch, n):
    """(the loss, the mean aux) of routing each of n data ranks' rows
    alone: each rank's forward, its NLL sum over the global mask count."""
    rows = B // n
    nll, auxes = 0.0, []
    with torch.no_grad():
        for r in range(n):
            b = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
            logits, aux = model.apply(params, b)
            nll += float(lm_nll(logits, b["targets"], b["loss_mask"], model.cfg.vocab)[0])
            auxes.append(float(aux))
    return nll / float(batch["loss_mask"].sum()), float(np.mean(auxes))


def test_the_batch_separates_whole_set_routing_from_per_rank_routing(moe):
    """On the first batch, routing each (2, 1) data rank's 32 tokens alone
    (groups of 32, not 64, each with its own capacity) drops other tokens
    than routing the 64 together: the NLL differs (the aux aside), which no
    difference of the aux alone could make."""
    _, model, params, batches, *_ = moe
    with torch.no_grad():
        logits, _ = model.apply(params, batches[0])
    whole = float(lm_loss(logits, batches[0]["targets"], batches[0]["loss_mask"],
                          model.cfg.vocab))
    per_rank, _ = _per_rank(model, params, batches[0], 2)
    assert abs(per_rank / whole - 1) > 1e-3, (whole, per_rank)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_moe_mesh_steps_match_one_by_one_and_the_reference(shape, moe):
    """N_STEPS steps on the mesh against 1 x 1 and the reference's jitted
    step, on the separating batches."""
    arch, model, params, batches, want_port, want_ref, _, _ = moe
    got = _port_run(model, params, batches, _mesh(shape))
    _assert_match(got, want_port, f"{arch} {shape} vs 1x1", want_ref[3])
    _assert_match(got, want_ref, f"{arch} {shape} vs the reference", want_ref[3])


def test_the_aux_is_the_whole_token_sets(moe):
    """The aux a (2, 1) step reports is the whole token set's, 1 x 1's
    (E · Σ_e mean prob_e · share_e over every token), where the mean of the
    data ranks' own auxes is another number on this batch."""
    _, model, params, batches, *_ = moe
    want = _step(model, params, batches[0], None)
    got = _step(model, params, batches[0], _mesh((2, 1)))
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]), rtol=REL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=REL)
    _, mean_aux = _per_rank(model, params, batches[0], 2)
    assert abs(mean_aux / float(want["aux"]) - 1) > 1e-3, (mean_aux, float(want["aux"]))


@pytest.fixture(scope="module")
def phi():
    rmodel, model = _models(MOE_ARCHS[0])
    rparams, params = _params_pair(model, 0)
    return rmodel, model, rparams, params, _separating_batches(model.cfg.vocab, 11)


@pytest.fixture(scope="module")
def phi_microbatch(phi):
    """(the reference's run, the port's 1 x 1 run) at microbatch=2."""
    rmodel, model, rparams, params, batches = phi
    return (_ref_run(rmodel, rparams, batches, microbatch=2),
            _port_run(model, params, batches, None, microbatch=2))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=str)
def test_microbatch_reports_no_aux_and_matches(shape, phi, phi_microbatch):
    """microbatch=2 on the mesh: aux 0 every step (the reference's scan
    reports none), and the steps equal 1 x 1's and the reference's."""
    _, model, _, params, batches = phi
    want_ref, want_port = phi_microbatch
    for b in batches:
        assert float(_step(model, params, b, _mesh(shape), microbatch=2)["aux"]) == 0.0
    got = _port_run(model, params, batches, _mesh(shape), microbatch=2)
    _assert_match(got, want_port, f"{shape} microbatch vs 1x1", want_ref[3])
    _assert_match(got, want_ref, f"{shape} microbatch vs the reference", want_ref[3])


def test_grad_compress_on_two_by_two(phi):
    rmodel, model, rparams, params, batches = phi
    want_ref = _ref_run(rmodel, rparams, batches, grad_compress=True)
    got = _port_run(model, params, batches, _mesh((2, 2)), grad_compress=True)
    _assert_match(got, _port_run(model, params, batches, None, grad_compress=True),
                  "(2, 2) grad_compress vs 1x1", want_ref[3])
    _assert_match(got, want_ref, "(2, 2) grad_compress vs the reference", want_ref[3])


def test_masks_that_differ_between_data_ranks_give_the_one_device_loss(phi):
    """Rank 0's rows mostly masked, rank 1's not, on (2, 1) and (2, 2):
    the one-device losses and steps."""
    _, model, _, params, batches = phi
    rng = np.random.default_rng(5)
    masked = []
    for b in batches:
        mask = np.ones((B, S), np.float32)
        mask[:B // 2] = rng.random((B // 2, S)) > 0.8
        mask[B // 2:] = rng.random((B // 2, S)) > 0.1
        masked.append({**b, "loss_mask": torch.from_numpy(mask)})
    want = _port_run(model, params, masked, None)
    for shape in ((2, 1), (2, 2)):
        _assert_match(_port_run(model, params, masked, _mesh(shape)), want,
                      f"{shape} uneven masks")


def test_expert_stacks_restore_onto_another_mesh(phi, tmp_path):
    """The elastic restart of reduced phi3.5-moe from (2, 2) to (1, 2): the
    (L, E, d, f) expert stacks and Adam's moments saved from one FSDP
    placement restore onto the other bit-equal, and training goes on."""
    _, model, _, _, batches = phi
    rep = elastic.simulate_failure_and_resume(
        model, str(tmp_path / "ck"), data_fn=lambda s: batches[s % N_STEPS], steps_each=2,
        batch=B, seq=S, devices=[torch.device("cpu")] * 4, model_parallel=2)
    assert rep.mesh_before == {"data": 2, "model": 2}
    assert rep.mesh_after == {"data": 1, "model": 2}
    assert rep.restored_equal and rep.resumed_step == 2
    assert np.isfinite(rep.loss_after)
