"""The port's compression pipeline (`repro_torch.core.api.compress_model`,
`repro_torch.optim.compress.allocate_bits`, on the CPU) against the
reference's, the same dense numpy weights through both; and the engine that
serves what it produces.

Tolerances: paths, bits assignments, centroid counts, smoothing choices,
codes and packed bytes are exact; codebooks rtol 1e-5 (f32 cluster means);
the empirical Fisher, whose gradients are elementwise here, exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.launch import engine as ref_engine
from repro.optim.compress import allocate_bits as ref_allocate_bits
from repro_torch.convert import from_reference
from repro_torch.core import api as port_api
from repro_torch.core.clustered_params import packed_weight_bytes
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.optim.compress import allocate_bits

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import assert_close, assert_equal, np_of, reference_model, to_numpy_tree

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]


def _port(tree):
    return from_reference(to_numpy_tree(tree), device="cpu")


def _assert_same_compression(got, want, what):
    """Port params/report vs the reference's: the same leaves clustered, the
    same widths, codes and packed bytes; codebooks to rtol 1e-5."""
    (pp, pr), (rp, rr) = got, want
    assert pr.bits_assignment == rr.bits_assignment, what
    assert pr.centroid_counts == rr.centroid_counts, what
    assert pr.smoothing == rr.smoothing, what
    assert (pr.params_clustered, pr.params_total) == (rr.params_clustered, rr.params_total)
    assert pr.mean_packed_bits == rr.mean_packed_bits
    assert pr.summary() == rr.summary() and pr.bits_table() == rr.bits_table()
    ref_leaves = dict(ref_api._flatten_with_paths(rp))
    port_leaves = dict(port_api._flatten_with_paths(pp))
    for path in rr.bits_assignment:
        ct = port_leaves[path]
        assert port_api.is_clustered(ct) and ct.nbits == rr.bits_assignment[path]
        r = {f: ref_leaves[f"{path}.{f}"] for f in port_api.CT_ARRAY_FIELDS
             if f"{path}.{f}" in ref_leaves}
        assert_equal(np_of(ct.packed), np.asarray(r["packed"]), f"{what} {path}: packed")
        assert_equal(np_of(ct.codes), np.asarray(r["codes"]), f"{what} {path}: codes")
        assert_close(np_of(ct.codebook), np.asarray(r["codebook"]), rtol=1e-5,
                     what=f"{what} {path}: codebook")
        for f in ("smooth", "inv_scale", "act_scale"):
            if f in r:
                assert_equal(np_of(getattr(ct, f)), np.asarray(r[f]), f"{what} {path}: {f}")
            else:
                assert getattr(ct, f) is None, f"{what} {path}: {f}"
        for key, rep in rr.per_layer.items():
            if key.startswith(path):
                assert pr.per_layer[key].centroid_history == rep.centroid_history


@pytest.fixture(scope="module")
def llama_dense():
    _, dense = reference_model("llama2-7b", seed=3, fused_projections=True)
    return dense


def test_eligible_paths_and_the_flattening_match_the_reference(llama_dense):
    ref = ref_api._flatten_with_paths(llama_dense)
    port = port_api._flatten_with_paths(_port(llama_dense))
    assert [p for p, _ in port] == [p for p, _ in ref]
    assert ([p for p, x in port if port_api.default_predicate(p, x)]
            == [p for p, x in ref if ref_api.default_predicate(p, x)])
    assert sum(port_api.default_predicate(p, x) for p, x in port) == 7
    for path in ("['x']['bias']", "['embed']", "['lm_head']", "['x']['b_up']",
                 "['x']['norm']['scale']", "['x']['u']", "['x']['w']"):
        x = np.zeros((4, 64, 64), np.float32)
        assert port_api.default_predicate(path, torch.from_numpy(x)) == \
            ref_api.default_predicate(path, x), path
    assert not port_api.default_predicate("['x']['w']", torch.zeros(4, 64, 16))
    assert not port_api.default_predicate("['x']['w']", torch.zeros(64))


@pytest.mark.parametrize("target,nbits", [(8, 4), (0, 3)], ids=["k8-4bit", "adaptive-3bit"])
def test_compress_model_on_reduced_llama(llama_dense, target, nbits):
    """Every stacked (L, d_in, d_out) leaf compressed slice by slice: at a
    fixed centroid target, and adaptively (3-bit: exactly 8 per slice)."""
    want = ref_api.compress_model(llama_dense, target_centroids=target, nbits=nbits)
    got = port_api.compress_model(_port(llama_dense), target_centroids=target, nbits=nbits)
    _assert_same_compression(got, want, f"target {target} nbits {nbits}")
    # dense leaves pass through untouched
    assert torch.equal(got[0]["embed"], _port(llama_dense)["embed"])


@pytest.mark.parametrize("budget", [3.0, 2.5])
def test_bits_budget_on_reduced_llama(llama_dense, budget):
    want = ref_api.compress_model(llama_dense, target_centroids=8, bits_budget=budget)
    got = port_api.compress_model(_port(llama_dense), target_centroids=8, bits_budget=budget)
    _assert_same_compression(got, want, f"budget {budget}")
    assert got[1].mean_packed_bits <= budget
    assert len(set(got[1].bits_assignment.values())) == (1 if budget == 3.0 else 2)


def test_compress_model_value_errors_keep_the_reference_wording(llama_dense):
    for kw in (dict(nbits=5), dict(bits_budget=1.5), dict(bits_budget=4.5)):
        with pytest.raises(ValueError) as ref_err:
            ref_api.compress_model(llama_dense, **kw)
        with pytest.raises(ValueError) as port_err:
            port_api.compress_model(_port(llama_dense), **kw)
        assert str(port_err.value) == str(ref_err.value)


def _small_tree(seed):
    rng = np.random.default_rng(seed)
    return {"layers": {"w1": rng.normal(0, 0.02, (2, 64, 48)).astype(np.float32),
                       "w2": rng.normal(0, 0.05, (64, 40)).astype(np.float32),
                       "norm": rng.normal(1, 0.1, (64,)).astype(np.float32)},
            "w_out": rng.normal(0, 0.03, (48, 64)).astype(np.float32)}


def test_smoothing_arms_the_quantized_path():
    """Captured input absmax -> adaptive smoothing per layer (Eq. 9): the
    same smoothing vector, s_q and inv_scale as the reference; identity
    leaves act_scale unset. Both the 2-D and the stacked layout."""
    tree = _small_tree(1)
    amax = np.abs(np.random.default_rng(2).normal(0, 1, 64)).astype(np.float32)
    amax[5] *= 40
    smooth_amax = {"['layers']['w1']": amax, "['layers']['w2']": amax}
    want = ref_api.compress_model(jax.tree_util.tree_map(jnp.asarray, tree),
                                  target_centroids=6, smooth_amax=smooth_amax)
    got = port_api.compress_model(jax.tree_util.tree_map(torch.from_numpy, tree),
                                  target_centroids=6, smooth_amax=smooth_amax)
    _assert_same_compression(got, want, "smoothed")
    assert got[1].smoothing["['layers']['w1']"] != "identity"
    assert got[1].smoothing["['w_out']"] == "identity"


def test_fisher_branch_against_jax_grad():
    """loss_fn + calib_batches: the empirical Fisher by torch.autograd against
    jax.grad, on a quadratic loss whose gradients (2 c w) are elementwise and
    exact in both; under a bits budget it decides the widths."""
    tree = _small_tree(3)
    rng = np.random.default_rng(4)
    batches = [{k: rng.uniform(0.1, 3.0, v.shape).astype(np.float32)
                for k, v in (("c1", tree["layers"]["w1"]), ("c2", tree["layers"]["w2"]),
                             ("c3", tree["w_out"]))} for _ in range(2)]
    batches[0]["c2"] *= 50                     # w2 is the sensitive layer

    def loss(p, b, xp):
        return (xp.sum(b["c1"] * p["layers"]["w1"] ** 2)
                + xp.sum(b["c2"] * p["layers"]["w2"] ** 2)
                + xp.sum(b["c3"] * p["w_out"] ** 2) + xp.sum(p["layers"]["norm"] ** 2))

    want = ref_api.compress_model(
        jax.tree_util.tree_map(jnp.asarray, tree), loss_fn=lambda p, b: loss(p, b, jnp),
        calib_batches=[jax.tree_util.tree_map(jnp.asarray, b) for b in batches],
        target_centroids=8, bits_budget=2.6)
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    ptree = jax.tree_util.tree_map(torch.from_numpy, tree)
    got = port_api.compress_model(ptree, loss_fn=lambda p, b: loss(p, b, torch),
                                  calib_batches=tb, target_centroids=8, bits_budget=2.6)
    _assert_same_compression(got, want, "fisher")
    bits = got[1].bits_assignment
    assert bits["['layers']['w2']"] == max(bits.values()) > min(bits.values())
    fisher = port_api._fisher(ptree, port_api._flatten_with_paths(ptree),
                              lambda p, b: loss(p, b, torch), tb)
    w2 = tree["layers"]["w2"]
    exact = np.mean([(2 * b["c2"] * w2) ** 2 for b in batches], axis=0)
    assert_close(np_of(fisher["['layers']['w2']"]), exact, rtol=1e-6, what="Fisher")


def test_allocate_bits_matches_the_reference():
    rng = np.random.default_rng(5)
    names = [f"l{i}" for i in range(9)]
    scores = dict(zip(names, rng.uniform(0, 1, 9).tolist()))
    scores["l3"] = scores["l4"]                              # a tie: broken by name
    sizes = dict(zip(names, rng.integers(100, 1000, 9).tolist()))
    for budget in (4.0, 3.5, 3.0, 2.7, 2.0):
        assert allocate_bits(scores, sizes, budget) == ref_allocate_bits(scores, sizes, budget)
    floor = {"l0": 4, "l1": 3}
    assert (allocate_bits(scores, sizes, 2.0, floor=floor)
            == ref_allocate_bits(scores, sizes, 2.0, floor=floor))
    assert allocate_bits({}, {}, 3.0) == {}
    for args in ((scores, sizes, 1.5), (scores, {"l0": 1}, 3.0)):
        with pytest.raises(ValueError) as ref_err:
            ref_allocate_bits(*args)
        with pytest.raises(ValueError) as port_err:
            allocate_bits(*args)
        assert str(port_err.value) == str(ref_err.value)


def _drive(engine, prompts, new_tokens):
    pending, requests = list(prompts), []
    while pending or engine.busy:
        if pending and engine.steps % 2 == 0:
            requests.append(engine.submit(pending.pop(0), max_new_tokens=new_tokens))
        if engine.busy:
            engine.step()
        else:
            engine.steps += 1
    return requests


def test_build_engine_compresses_dense_weights_like_the_reference(llama_dense):
    """build_engine(lcd=True) on the same dense weights: both compress them,
    and the two engines emit the same greedy tokens for the same staggered
    requests."""
    kw = dict(num_slots=3, block_size=4, num_blocks=48, max_blocks_per_slot=12,
              prefill_chunk=8)
    ref, _ = ref_engine.build_engine("llama2-7b", lcd=True, params=llama_dense,
                                     ecfg=ref_engine.EngineConfig(**kw))
    port, params = port_engine.build_engine("llama2-7b", lcd=True, params=_port(llama_dense),
                                            ecfg=port_engine.EngineConfig(**kw), device="cpu")
    assert port.compress_report is not None
    assert port.compress_report.bits_assignment == ref.compress_report.bits_assignment
    assert packed_weight_bytes(params) == sum(
        np.asarray(ct.packed).size for ct in jax.tree_util.tree_leaves(
            ref.params, is_leaf=ref_api.is_clustered) if ref_api.is_clustered(ct))
    prompts = [np.random.default_rng(6 + i).integers(0, 512, 5 + 3 * i).astype(np.int32)
               for i in range(4)]
    want = [r.out_tokens for r in _drive(ref, prompts, 6)]
    got = [r.out_tokens for r in _drive(port, prompts, 6)]
    assert got == want, (f"port {got} vs reference {want}; check the reference's top-2 "
                         f"logit margin before calling it a fault")


def test_serve_with_a_bits_budget_and_the_describe_cli(capsys):
    stats = {}
    gen, params = port_engine.serve("llama2-7b", lcd=True, bits_budget=3.0, batch=2,
                                    prompt_len=5, gen_tokens=3, stats=stats, device="cpu")
    assert gen.shape == (2, 3)
    assert stats["mean_packed_bits"] <= 3.0 and len(stats["bits_assignment"]) == 7
    assert {params["blocks"]["mlp"]["w_up"].nbits} <= {2, 3, 4}
    out = port_serve.main(["--arch", "llama2-7b", "--reduced", "--lcd", "--continuous",
                           "--describe", "--bits-budget", "2.5", "--device", "cpu"])
    assert out == []
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "llama2-7b", "--reduced", "--describe", "--device", "cpu"])
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "llama2-7b", "--reduced", "--bits-budget", "x",
                         "--device", "cpu"])


def test_compress_report_fields_match_the_reference():
    assert ([f.name for f in dataclasses.fields(port_api.CompressReport)]
            == [f.name for f in dataclasses.fields(ref_api.CompressReport)])
