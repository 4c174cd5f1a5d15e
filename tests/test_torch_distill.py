"""The port's LCD distillation loop (`repro_torch.core.distill`, on the CPU)
against the reference's (`repro.core.distill`): one `lcd_step`, the full
`distill_layer` for every init and both ablation flags, and
`distill_layer_to_k`, the same numpy weights and Hessians through both.

Tolerances: codes, active masks and the centroid-count history are exact (the
loop's control flow must not diverge); centroids and the objective rtol 1e-5
(f32 sums that may be taken in another order); the trace monitor rtol 1e-4
(it multiplies the objective by a sum of the whole Hessian)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as RC
from repro.core import distill as RD
from repro_torch.core import clustering as PC
from repro_torch.core import distill as PD

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import assert_close, assert_equal, np_of

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]


def _layer(seed, shape=(64, 48)):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.02, shape).astype(np.float32)
    w.reshape(-1)[rng.choice(w.size, 8, replace=False)] *= 6
    h = rng.uniform(0.3, 2.0, shape[0]).astype(np.float32)       # per input channel
    return w, np.broadcast_to(h[:, None], shape).astype(np.float32)


def _same(pc, ps, rc, rs, what):
    assert_equal(np_of(pc), np.asarray(rc), f"{what}: codes")
    act = np.asarray(rs.active)
    assert_equal(np_of(ps.active), act, f"{what}: active")
    assert_close(np_of(ps.centroids)[act], np.asarray(rs.centroids)[act], rtol=1e-5,
                 what=f"{what}: centroids")


def test_lcd_config_and_report_fields_match_the_reference():
    ref = {f.name: f.default for f in dataclasses.fields(RD.LCDConfig)}
    assert {f.name: f.default for f in dataclasses.fields(PD.LCDConfig)} == ref
    assert ([f.name for f in dataclasses.fields(PD.DistillReport)]
            == [f.name for f in dataclasses.fields(RD.DistillReport)])


@pytest.mark.parametrize("eta", [1.0, 0.7], ids=["eta1", "eta0.7"])
@pytest.mark.parametrize("rule", ["salience", "closest"])
@pytest.mark.parametrize("allow_merge", [True, False], ids=["merge", "nomerge"])
def test_lcd_step(eta, rule, allow_merge):
    w, h = _layer(1)
    rs = RC.make_state(RC.dbci_init(w).centroids)
    rc = RC.assign(jnp.asarray(w), rs)
    ps = PC.make_state(RC.dbci_init(w).centroids, device="cpu")
    pc = PC.assign(torch.from_numpy(w), ps)
    for step in range(8):
        rc, rs, rj, rm = RD.lcd_step(jnp.asarray(w), rc, rs, jnp.asarray(h), eta, 0.5, 2,
                                     allow_merge=allow_merge, merge_rule=rule)
        pc, ps, pj, pm = PD.lcd_step(torch.from_numpy(w), pc, ps, torch.from_numpy(h), eta,
                                     0.5, 2, allow_merge=allow_merge, merge_rule=rule)
        assert bool(pm) == bool(rm), f"step {step}: merge decision"
        assert_close(float(pj), float(rj), rtol=1e-5, what=f"step {step}: J")
        _same(pc, ps, rc, rs, f"step {step}")
    assert bool(rm) == allow_merge or not allow_merge


def _compare_runs(got, want, what):
    (pc, ps, prep), (rc, rs, rrep) = got, want
    _same(pc, ps, rc, rs, what)
    assert prep.centroid_history == rrep.centroid_history, what
    assert_close(prep.objective_history, rrep.objective_history, rtol=1e-5,
                 what=f"{what}: objective history")
    assert_close(prep.trace_history, rrep.trace_history, rtol=1e-4,
                 what=f"{what}: trace history")
    assert ([(s, e.split()[0]) for s, e in prep.speculative_events]
            == [(s, e.split()[0]) for s, e in rrep.speculative_events]), what
    assert_close(prep.final_centroids, rrep.final_centroids, rtol=1e-5,
                 what=f"{what}: final centroids")
    assert_close(prep.final_objective, rrep.final_objective, rtol=1e-5,
                 what=f"{what}: final objective")


RUNS = [("dbci", True, True), ("dbci", True, False), ("dbci", False, True),
        ("dbci", False, False), ("naive4bit", True, True), ("kmeans:12", True, True)]


@pytest.mark.parametrize("init,progressive,speculative", RUNS,
                         ids=["-".join(map(str, r)) for r in RUNS])
def test_distill_layer(init, progressive, speculative):
    """Adaptive mode (theta = 0.04): merges while the distortion allows,
    speculative restarts with the 2 eps -> 1.5 eps back-off on stagnation."""
    w, h = _layer(2)
    cfg = PD.LCDConfig(max_steps=120, spec_patience=10, spec_iters=8)
    kw = dict(init=init, progressive=progressive, speculative=speculative)
    want = RD.distill_layer(w, h, RD.LCDConfig(**dataclasses.asdict(cfg)), **kw)
    got = PD.distill_layer(w, h, cfg, device="cpu", **kw)
    assert got[0].dtype == torch.int32 and got[0].device.type == "cpu"
    _compare_runs(got, want, f"distill_layer {kw}")


def test_distill_layer_speculative_search_runs_and_matches():
    """A layer and a patience for which the speculative search fires, with
    both an accepted and a reverted candidate somewhere in the run."""
    w, h = _layer(3, (80, 64))
    cfg = PD.LCDConfig(max_steps=150, spec_patience=6, spec_iters=5, theta=0.02,
                       spec_rounds=4)
    want = RD.distill_layer(w, h, RD.LCDConfig(**dataclasses.asdict(cfg)))
    got = PD.distill_layer(w, h, cfg, device="cpu")
    assert want[2].speculative_events, "the search never fired: re-tune the test layer"
    _compare_runs(got, want, "speculative")


def test_distill_layer_refuses_an_unknown_init():
    w, h = _layer(4)
    with pytest.raises(ValueError, match="unknown init"):
        PD.distill_layer(w, h, init="random", device="cpu")


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("rule", ["salience", "closest"])
def test_distill_layer_to_k(k, rule):
    w, h = _layer(5)
    want = RD.distill_layer_to_k(w, h, k, RD.LCDConfig(merge_rule=rule))
    got = PD.distill_layer_to_k(w, h, k, PD.LCDConfig(merge_rule=rule), device="cpu")
    _compare_runs(got, want, f"to_k {k} {rule}")
    assert len(got[2].final_centroids) == k
    # tensor inputs: the same run on the tensors' device
    again = PD.distill_layer_to_k(torch.from_numpy(w), torch.from_numpy(h), k,
                                  PD.LCDConfig(merge_rule=rule))
    assert torch.equal(again[0], got[0])
