"""The port's speculative self-drafting against the reference, on the CPU:
`dequantize_params` and `make_draft_params` (codes and packed bytes exact,
codebooks rtol 1e-5), `paged_verify_step` (logits at every window position,
float transform, rtol 1e-5 with atol 1e-5 x the largest logit), and the
engine with `speculative_k = 3` — tokens equal to the port's non-speculative
engine on float and int8 pools, tokens and `accept_lens` equal to the
reference engine's, full acceptance with the identical draft, KV rollback
after a partial rejection, allocator exhaustion and a starved round, bounded
step shapes, the CLI.

The model is the reference's `tiny-spec` configuration (2 layers, d_model 64,
4 query heads over 2 kv heads, vocab 256, f32) with head_dim 32 instead of
16: the port's paged attention takes a head dim that is a multiple of 32 on
every device, as the card does. Both packages run the same configuration,
and reduced llama2-7b is the second case."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustered_params as ref_cp
from repro.launch import engine as ref_engine
from repro.models import transformer as ref_tf
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.registry import get_model as ref_get_model
from repro_torch.convert import from_reference
from repro_torch.core import clustered_params as port_cp
from repro_torch.core.api import is_clustered
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as port_tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (CLUSTERED_LEAVES, assert_close, assert_equal, cluster_params, np_of,
                  port_model, reference_model, to_numpy_tree)

pytestmark = pytest.mark.tier1

K = 3          # draft tokens per verify round
VOCAB = 256
TINY = dict(arch_id="tiny-spec", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=VOCAB, head_dim=32, dtype="float32")
SPECS = [(60, 5, 8), (61, 9, 6), (62, 3, 7), (63, 11, 5)]


@pytest.fixture(scope="module")
def tiny():
    """(reference model, reference params, port model, port params): the same
    dense f32 weights from key 0 in both packages."""
    ref_model = ref_get_model(RefModelConfig(**TINY))
    ref_params = ref_model.init(jax.random.key(0))
    return (ref_model, ref_params, get_model(ModelConfig(**TINY)),
            from_reference(to_numpy_tree(ref_params), device="cpu"))


@pytest.fixture(scope="module")
def drafts(tiny):
    """The 2-bit self-draft of the tiny model, made by each package."""
    _, ref_params, _, port_params = tiny
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # many small ops: threads only wait on each other
    try:
        port, _ = port_cp.make_draft_params(port_params, draft_centroids=4)
    finally:
        torch.set_num_threads(n)
    ref, _ = ref_cp.make_draft_params(ref_params, draft_centroids=4)
    return ref, port


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _ecfg(**kw):
    return port_engine.EngineConfig(**{**dict(num_slots=3, block_size=4, num_blocks=24,
                                              max_blocks_per_slot=8, prefill_chunk=8), **kw})


def _run_staggered(engine, specs, vocab=VOCAB):
    """Staggered arrivals (a fresh request every other step); returns the
    requests in the order of `specs`."""
    reqs, pending = [], list(specs)
    while pending or engine.busy:
        if pending and engine.steps % 2 == 0:
            s, n, g = pending.pop(0)
            reqs.append(engine.submit(
                np.random.default_rng(s).integers(0, vocab, n).astype(np.int32), g))
        if engine.busy:
            engine.step()
        else:
            engine.steps += 1
    engine.assert_bounded_traces()
    return reqs


def _port(model, params, draft=None, **kw):
    return port_engine.ServingEngine(model, params, _ecfg(**kw), draft_params=draft,
                                     device="cpu")


def _leaves(tree, path=""):
    """(path, leaf) pairs; a ClusteredTensor, or its numpy form (a dict with
    `nbits`), is one leaf."""
    if isinstance(tree, dict) and "nbits" not in tree:
        return [pl for k in sorted(tree) for pl in _leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# dequantize_params, make_draft_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["full_codes", "packed_codes"])
@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_dequantize_params_equals_the_reference(tiny, nbits, layout):
    _, ref_params, _, _ = tiny
    target = cluster_params(ref_params, nbits, smooth_seed=5)
    if layout == "packed_codes":       # what materialize_clustered holds: codes packed
        target = jax.tree_util.tree_map(
            lambda ct: ct._replace(codes=ct.packed) if isinstance(ct, ref_cp.ClusteredTensor)
            else ct, target, is_leaf=lambda x: isinstance(x, ref_cp.ClusteredTensor))
    want = to_numpy_tree(ref_cp.dequantize_params(target))
    got = port_cp.dequantize_params(from_reference(to_numpy_tree(target), device="cpu"))
    for (path, w), (gpath, g) in zip(_leaves(want), _leaves(got)):
        assert path == gpath and not is_clustered(g)
        assert_close(np_of(g), w, what=f"dequantized {path} (exact)")
    assert sum(1 for _, g in _leaves(got) if g.ndim == 3) == len(CLUSTERED_LEAVES)


@pytest.mark.parametrize("source", ["dense", "lcd_target"])
@pytest.mark.parametrize("centroids,bits", [(4, 2), (8, 3)])
def test_make_draft_params_equals_the_reference(tiny, centroids, bits, source,
                                                one_torch_thread):
    _, ref_params, _, _ = tiny
    if source == "lcd_target":         # a compressed target is dequantized first
        ref_params = cluster_params(ref_params, 4, smooth_seed=3)
    port_params = from_reference(to_numpy_tree(ref_params), device="cpu")
    ref_draft, ref_rep = ref_cp.make_draft_params(ref_params, draft_centroids=centroids)
    draft, rep = port_cp.make_draft_params(port_params, draft_centroids=centroids)
    want = dict(_leaves(to_numpy_tree(ref_draft)))
    n_clustered = 0
    for path, leaf in _leaves(draft):
        if not is_clustered(leaf):
            assert_close(np_of(leaf), want[path], what=f"{path} passes through")
            continue
        n_clustered += 1
        w = want[path]
        assert leaf.nbits == w["nbits"] == bits, path
        assert_equal(np_of(leaf.codes), w["codes"], f"{path}: codes")
        assert_equal(np_of(leaf.packed), w["packed"], f"{path}: packed bytes")
        assert_close(np_of(leaf.codebook), w["codebook"], rtol=1e-5, what=f"{path}: codebook")
        assert_close(np_of(leaf.smooth), w["smooth"], what=f"{path}: smooth")
    assert n_clustered == len(CLUSTERED_LEAVES)
    assert port_cp.packed_weight_bytes(draft) == ref_cp.packed_weight_bytes(ref_draft)
    assert rep.equivalent_bits == pytest.approx(ref_rep.equivalent_bits)
    assert rep.bits_assignment == ref_rep.bits_assignment
    if bits == 2:
        assert 2 * port_cp.packed_weight_bytes(draft) == port_cp.packed_weight_bytes(draft, 4)


def _fake_compress(nbits, codes_rows):
    """A stand-in for compress_model returning one clustered leaf packed at
    `nbits` with `codes_rows` rows of packed codes (d_in = 64, d_out = 32)."""
    def fake(dense, **_):
        ct = port_cp.ClusteredTensor(codes=torch.zeros((codes_rows, 32), dtype=torch.uint8),
                                     codebook=torch.zeros(4), smooth=torch.ones(64),
                                     nbits=nbits)
        return {"w": ct}, "report"
    return fake


@pytest.mark.parametrize("case", ["wider_leaf", "too_many_bytes"])
def test_make_draft_params_postconditions_raise(monkeypatch, case):
    if case == "wider_leaf":
        monkeypatch.setattr(port_cp, "compress_model", _fake_compress(4, 32))
        with pytest.raises(ValueError, match="draft leaf packed at 4-bit; expected 2-bit"):
            port_cp.make_draft_params({}, draft_centroids=4)
    else:
        monkeypatch.setattr(port_cp, "compress_model", _fake_compress(2, 16))
        real = port_cp.packed_weight_bytes
        monkeypatch.setattr(port_cp, "packed_weight_bytes",
                            lambda p, nbits=None: real(p, nbits) * (1 if nbits else 3))
        with pytest.raises(ValueError, match="2-bit draft must stream ≤ half the int4"):
            port_cp.make_draft_params({}, draft_centroids=4)


# ---------------------------------------------------------------------------
# paged_verify_step
# ---------------------------------------------------------------------------

def _verify_case(which):
    """(reference model, reference params): tiny dense, or reduced llama2-7b
    with 4-bit clustered weights on the float transform."""
    if which == "tiny":
        m = ref_get_model(RefModelConfig(**TINY))
        return m, m.init(jax.random.key(1))
    model, dense = reference_model("llama2-7b", seed=1, n_layers=2)
    return model, cluster_params(dense, 4, smooth_seed=2)


@pytest.mark.parametrize("which", ["tiny", "llama_lcd_float"])
def test_paged_verify_step_logits_match_the_reference(which):
    """A prefill chunk through paged_decode_step, then two width-4 verifies
    (one slot idle, one partial): logits at every position of every slot
    that feeds, and the pools after. Float pools: the int8 pool's absmax
    quantizer turns an f32 ulp between the packages into another code (one
    V code of this case differs already after the prefill, moving logits by
    5e-4), so whole-model logits over it are not held to 1e-5; the int8
    verify is held to the port's own width-1 steps below."""
    model, params = _verify_case(which)
    cfg = model.cfg
    pcfg = ModelConfig(**TINY) if which == "tiny" else port_model("llama2-7b", n_layers=2).cfg
    rng = np.random.default_rng(23)
    S, nb, bs, nbw = 3, 16, 4, 5
    cache = ref_tf.init_paged_cache(cfg, nb, bs, "float")
    pparams = from_reference(to_numpy_tree(params), device="cpu")
    pcache = from_reference(to_numpy_tree(cache), device="cpu")
    tables = rng.permutation(nb)[:S * nbw].reshape(S, nbw).astype(np.int32)
    lengths = np.zeros(S, np.int32)
    prefill = (rng.integers(0, cfg.vocab, (S, 8)).astype(np.int32),
               np.array([8, 0, 6], np.int32))
    verifies = [(rng.integers(0, cfg.vocab, (S, K + 1)).astype(np.int32),
                 np.array([K + 1, 0, n], np.int32)) for n in (K + 1, 2)]
    for i, (tokens, n_new) in enumerate([prefill] + verifies):
        args = (tokens, lengths, n_new, tables)
        ref_fn = ref_tf.paged_decode_step if i == 0 else ref_tf.paged_verify_step
        port_fn = port_tf.paged_decode_step if i == 0 else port_tf.paged_verify_step
        want, cache = ref_fn(params, cache, *map(jnp.asarray, args), cfg)
        got, pcache = port_fn(pparams, pcache, *map(torch.from_numpy, args), pcfg)
        if i:
            assert got.shape == (S, K + 1, cfg.padded_vocab)
            want, got = np.asarray(want), np_of(got)
            for s in range(S):
                n = int(n_new[s])
                assert_close(got[s, :n], want[s, :n], rtol=1e-5,
                             atol=1e-5 * float(np.abs(want).max()),
                             what=f"{which} verify {i} slot {s} logits")
        lengths = lengths + n_new
    for name, want in cache.items():
        assert_close(np_of(pcache[name]), np.asarray(want), rtol=1e-6, atol=1e-5,
                     what=f"{name} pool")


@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
def test_verify_rows_equal_width_one_steps(tiny, kv_dtype):
    """Inside the port: row j of one width-(k+1) verify against the j-th of
    k+1 width-1 steps on a copy of the same pool (what spec == greedy rests
    on; torch.equal on the card, where chip_smoke.py checks it)."""
    _, _, model, params = tiny
    cfg = model.cfg
    pool = port_tf.init_paged_cache(cfg, 16, 4, kv_dtype, device="cpu")
    rng = np.random.default_rng(4)
    tables = torch.from_numpy(rng.permutation(16)[:12].reshape(3, 4).astype(np.int32))
    prompt = torch.from_numpy(rng.integers(0, VOCAB, (3, 6)).astype(np.int32))
    lengths = torch.zeros(3, dtype=torch.int32)
    port_tf.paged_decode_step(params, pool, prompt, lengths,
                              torch.tensor([6, 6, 0], dtype=torch.int32), tables, cfg)
    lengths = torch.tensor([6, 6, 0], dtype=torch.int32)
    n_one = torch.tensor([1, 1, 0], dtype=torch.int32)
    tokens = torch.from_numpy(rng.integers(0, VOCAB, (3, K + 1)).astype(np.int32))
    wide_pool = {k: v.clone() for k, v in pool.items()}
    wide, _ = port_tf.paged_verify_step(params, wide_pool, tokens, lengths, n_one * (K + 1),
                                        tables, cfg)
    for j in range(K + 1):
        one, _ = port_tf.paged_decode_step(params, pool, tokens[:, j:j + 1].contiguous(),
                                           lengths + j * n_one, n_one, tables, cfg)
        assert_close(np_of(wide[:2, j]), np_of(one[:2]), rtol=1e-6, atol=1e-6,
                     what=f"verify row {j} vs width-1 step {j}")
    for name in pool:
        if pool[name].dtype == torch.int8:
            assert_equal(np_of(wide_pool[name]), np_of(pool[name]), f"{name} codes")
        else:
            assert_close(np_of(wide_pool[name]), np_of(pool[name]), atol=1e-6, what=name)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
def test_spec_tokens_equal_the_plain_engine(tiny, drafts, kv_dtype):
    """THE speculative contract: staggered arrivals sharing slots in
    different phases, request for request the same tokens as the
    non-speculative engine; every block returned."""
    _, _, model, params = tiny
    ones = np.ones((2, 2, 32), np.float32)
    smooth = (ones * 1.25, ones * 0.8) if kv_dtype == "int8" else None
    kw = dict(kv_dtype=kv_dtype)

    def engine(**extra):
        return port_engine.ServingEngine(model, params, _ecfg(**kw, **extra),
                                         draft_params=drafts[1] if extra else None,
                                         kv_smooth=smooth, device="cpu")
    ref = _run_staggered(engine(), SPECS)
    spec_eng = engine(speculative_k=K)
    spec = _run_staggered(spec_eng, SPECS)
    assert set(spec_eng.traces) == {("prefill", 8), ("draft", K), ("verify", K + 1)}
    assert [r.out_tokens for r in spec] == [r.out_tokens for r in ref]
    assert all(r.state == "finished" for r in spec)
    assert spec_eng.alloc.num_free == spec_eng.ecfg.num_blocks
    if kv_dtype == "int8":             # each pool holds the smoothing values in its own tensors
        tp, dp = spec_eng.caches["paged"], spec_eng.draft_caches["paged"]
        assert torch.equal(tp["k_smooth"], dp["k_smooth"])
        assert tp["k_smooth"].data_ptr() != dp["k_smooth"].data_ptr()


def _reference_spec_run(ref_model, ref_params, ref_draft, specs, vocab):
    eng = ref_engine.ServingEngine(ref_model, ref_params, ref_engine.EngineConfig(
        num_slots=3, block_size=4, num_blocks=24, max_blocks_per_slot=8, prefill_chunk=8,
        speculative_k=K), draft_params=ref_draft)
    return _run_staggered(eng, specs, vocab), eng


@pytest.mark.parametrize("which", ["tiny", "llama_lcd"])
def test_spec_tokens_and_accept_lens_equal_the_reference_engine(tiny, drafts, which,
                                                                one_torch_thread):
    """The same target and draft (the reference's draft carried across) and
    arrivals: the same tokens, the same accepted lengths round for round, the
    same rounds and block tables at the end. llama: reduced llama2-7b with a
    4-bit clustered target, its draft made by each package from it."""
    if which == "tiny":
        ref_model, ref_params, model, params = tiny
        ref_draft, _ = drafts
        specs = SPECS
    else:
        ref_model, dense = reference_model("llama2-7b", seed=2, n_layers=2)
        ref_params = cluster_params(dense, 4, smooth_seed=5)
        ref_draft, _ = ref_cp.make_draft_params(ref_params, draft_centroids=4)
        model = port_model("llama2-7b", n_layers=2)
        params = from_reference(to_numpy_tree(ref_params), device="cpu")
        specs = [(70, 9, 7), (71, 4, 6), (72, 12, 5)]
    vocab = ref_model.cfg.vocab
    want, ref_eng = _reference_spec_run(ref_model, ref_params, ref_draft, specs, vocab)
    draft = from_reference(to_numpy_tree(ref_draft), device="cpu")
    got_eng = _port(model, params, draft, speculative_k=K)
    got = _run_staggered(got_eng, specs, vocab)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [r.accept_lens for r in got] == [r.accept_lens for r in want]
    assert got_eng.spec_rounds == ref_eng.spec_rounds
    assert got_eng.acceptance_summary() == ref_eng.acceptance_summary()
    if which == "llama_lcd":           # and the port's own draft: codes equal the reference's
        own, _ = port_cp.make_draft_params(params, draft_centroids=4)
        got = _run_staggered(_port(model, params, own, speculative_k=K), specs, vocab)
        assert [r.accept_lens for r in got] == [r.accept_lens for r in want]


def test_identical_draft_accepts_every_uncapped_round(tiny):
    """The degenerate but legal draft, the target itself: every round of a
    long generation emits k + 1 tokens — had the draft cache a hole after a
    fully accepted round, acceptance would collapse within a few rounds —
    and the output still equals plain greedy."""
    _, _, model, params = tiny
    specs = [(70, 6, 18)]
    ref = _run_staggered(_port(model, params), specs)
    eng = _port(model, params, params, speculative_k=K)
    spec = _run_staggered(eng, specs)
    assert spec[0].out_tokens == ref[0].out_tokens
    assert len(spec[0].accept_lens) >= 3
    assert all(a == K for a in spec[0].accept_lens[:-1]), spec[0].accept_lens
    assert eng.acceptance_summary()["mean_accepted_len"] > K


def test_kv_rollback_after_partial_rejection(tiny):
    """A near-target draft (one MLP weight perturbed) gets long prefixes
    accepted and tails rejected; after every step the slot's readable cache
    covers exactly prompt + emitted - pending, and the output equals plain
    greedy."""
    _, _, model, params = tiny
    noisy = {**params, "blocks": {**params["blocks"], "mlp": dict(params["blocks"]["mlp"])}}
    w = params["blocks"]["mlp"]["w_up"]
    noisy["blocks"]["mlp"]["w_up"] = w + 0.02 * torch.randn(
        w.shape, generator=torch.Generator().manual_seed(9))
    eng = _port(model, params, noisy, speculative_k=K)
    r = eng.submit(_prompt(80, 6), 12)
    plain = _port(model, params)
    ref = plain.submit(_prompt(80, 6), 12)
    plain.run()
    while eng.busy:
        eng.step()
        if r.slot is not None and r.out_tokens and not r.prefilling:
            assert int(eng.lengths[r.slot]) == len(r.prompt) + len(r.out_tokens) - 1
    eng.assert_bounded_traces()
    assert r.out_tokens == ref.out_tokens
    assert any(a > 0 for a in r.accept_lens), "the perturbed draft accepted nothing"
    assert any(a < K for a in r.accept_lens), "the perturbed draft was never rejected"


def _assert_pool_partitioned(eng):
    owned = [b for r in eng.slots if r is not None for b in r.blocks]
    free = list(eng.alloc._free)
    assert len(owned) == len(set(owned)), f"double-owned: {owned}"
    assert not set(owned) & set(free), "block both owned and free"
    assert sorted(owned + free) == list(range(eng.ecfg.num_blocks))


def test_allocator_exhaustion_during_drafting(tiny, drafts):
    """Each round reserves lengths + k + 1 up front, so a pool sized for one
    long request refuses the second admission (no partial grant) while the
    first drafts; the pool stays partitioned and both finish."""
    _, _, model, params = tiny
    ecfg = port_engine.EngineConfig(num_slots=2, block_size=4, num_blocks=6,
                                    max_blocks_per_slot=5, prefill_chunk=8, speculative_k=K)
    eng = port_engine.ServingEngine(model, params, ecfg, draft_params=drafts[1], device="cpu")
    r1, r2 = eng.submit(_prompt(95, 8), 8), eng.submit(_prompt(96, 8), 8)
    refused = False
    while eng.busy:
        eng.step()
        _assert_pool_partitioned(eng)
        if r2.state == "queued" and r1.state == "running":
            refused = True
            assert r2.slot is None and not r2.blocks
    assert refused, "pool pressure never refused an admission"
    eng.assert_bounded_traces()
    assert r1.state == r2.state == "finished"
    assert len(r1.out_tokens) == len(r2.out_tokens) == 8
    assert eng.alloc.num_free == ecfg.num_blocks


def test_starved_round_waits_without_corruption(tiny, drafts):
    """Two requests on a pool that cannot hold both with k + 1 of headroom:
    reservations preempt, both drain with the reference engine's tokens and
    lengths step for step, and the pool returns whole."""
    ref_model, ref_params, model, params = tiny
    kw = dict(num_slots=2, block_size=2, num_blocks=9, max_blocks_per_slot=9,
              prefill_chunk=4, speculative_k=K)
    eng = port_engine.ServingEngine(model, params, port_engine.EngineConfig(**kw),
                                    draft_params=drafts[1], device="cpu")
    ref = ref_engine.ServingEngine(ref_model, ref_params, ref_engine.EngineConfig(**kw),
                                   draft_params=drafts[0])
    reqs = [(e.submit(_prompt(97, 4), 7), e.submit(_prompt(98, 4), 7)) for e in (eng, ref)]
    while eng.busy:
        eng.step()
        ref.step()
        _assert_pool_partitioned(eng)
        assert_equal(eng.lengths, ref.lengths, "slot lengths")
    r1, r2 = reqs[0]
    assert r1.state == r2.state == "finished" and not ref.busy
    assert len(r1.out_tokens) == len(r2.out_tokens) == 7
    assert r1.preemptions + r2.preemptions >= 1, "the pressure was not real"
    assert [r.out_tokens for r in reqs[0]] == [r.out_tokens for r in reqs[1]]
    assert eng.alloc.num_free == eng.ecfg.num_blocks


def test_a_round_nobody_can_join_emits_nothing(tiny, drafts):
    """A decoding slot whose blocks cannot be grown to lengths + k + 1 sits
    the round out; when no slot can join, the round runs no model step,
    advances `steps`, emits nothing and writes no pool. Then the request
    goes on to plain greedy's tokens."""
    _, _, model, params = tiny
    eng = _port(model, params, drafts[1], speculative_k=K)
    r = eng.submit(_prompt(99, 5), 8)
    while not r.out_tokens:
        eng.step()
    assert len(r.blocks) * 4 < int(eng.lengths[r.slot]) + K + 1, "already covered"
    pools = [{k: v.clone() for k, v in c["paged"].items()} for c in (eng.caches, eng.draft_caches)]
    steps, traces, rounds = eng.steps, dict(eng.traces), eng.spec_rounds
    tokens, blocks, lengths = list(r.out_tokens), list(r.blocks), eng.lengths.copy()
    eng._ensure_blocks = lambda req, n: False          # no block to be had this round
    eng.step()
    del eng._ensure_blocks
    assert eng.steps == steps + 1
    assert eng.traces == traces and eng.spec_rounds == rounds
    assert r.out_tokens == tokens and r.blocks == blocks
    assert_equal(eng.lengths, lengths, "lengths")
    for c, before in zip((eng.caches, eng.draft_caches), pools):
        for k, v in c["paged"].items():
            assert torch.equal(v, before[k]), f"a starved round wrote pool {k}"
    eng.run()
    plain = _port(model, params)
    ref = plain.submit(_prompt(99, 5), 8)
    plain.run()
    assert r.out_tokens == ref.out_tokens


def test_bounded_shapes_and_acceptance_bookkeeping(tiny, drafts):
    """One request: every round records 0 <= accepted <= k, emitted tokens
    reconcile exactly with the log (the first from prefill, round i emits
    accept_lens[i] + 1), the summary agrees; only the three speculative
    shapes ran, and a foreign one is caught."""
    _, _, model, params = tiny
    eng = _port(model, params, drafts[1], speculative_k=K)
    r = _run_staggered(eng, [(90, 5, 9)])[0]
    assert all(0 <= a <= K for a in r.accept_lens)
    assert 1 + sum(a + 1 for a in r.accept_lens) == len(r.out_tokens) == 9
    summ = eng.acceptance_summary()
    assert summ["accept_entries"] == len(r.accept_lens) == summ["spec_rounds"]
    assert sum(summ["accepted_len_hist"].values()) == summ["accept_entries"]
    assert summ["mean_accepted_len"] == pytest.approx(np.mean([a + 1 for a in r.accept_lens]))
    assert set(eng.traces) == {("prefill", 8), ("draft", K), ("verify", K + 1)}
    assert eng.traces[("draft", K)] == eng.traces[("verify", K + 1)] == eng.spec_rounds
    eng.traces[1] = 1                  # a plain width in speculative mode
    with pytest.raises(AssertionError, match="unexpected step shapes"):
        eng.assert_bounded_traces()


def test_speculation_needs_draft_params_and_headroom(tiny, drafts):
    _, _, model, params = tiny
    with pytest.raises(ValueError, match="speculative decoding needs draft_params"):
        _port(model, params, speculative_k=K)
    eng = _port(model, params, drafts[1], speculative_k=K)      # max_seq 32
    with pytest.raises(ValueError, match="incl. speculative headroom 3"):
        eng.submit(np.arange(20), 10)
    eng.submit(np.arange(20), 9)
    with pytest.warns(DeprecationWarning, match="draft_caches"):
        assert eng.draft_cache is eng.draft_caches["paged"]
    assert _port(model, params).draft_caches is None


def test_build_engine_makes_the_draft(one_torch_thread):
    """build_engine with speculative_k and no draft_params re-clusters the
    (compressed) target into the 2-bit draft itself, reports it, and serves
    plain greedy's tokens."""
    ecfg = port_engine.EngineConfig(num_slots=2, block_size=4, num_blocks=32,
                                    max_blocks_per_slot=8, prefill_chunk=8, speculative_k=2)
    eng, params = port_engine.build_engine("llama2-7b", lcd=True, ecfg=ecfg, n_layers=2,
                                           device="cpu")
    assert eng.draft_report is not None and eng.compress_report is not None
    assert set(eng.draft_report.bits_assignment.values()) == {2}
    assert all(leaf.nbits == 2 for _, leaf in _leaves(eng.draft_params) if is_clustered(leaf))
    plain = port_engine.ServingEngine(eng.model, params, dataclasses.replace(
        ecfg, speculative_k=0), device="cpu")
    specs = [(3, 7, 6), (4, 12, 5)]
    vocab = eng.model.cfg.vocab
    assert [r.out_tokens for r in _run_staggered(eng, specs, vocab)] == \
        [r.out_tokens for r in _run_staggered(plain, specs, vocab)]


@pytest.mark.usefixtures("one_torch_thread")
def test_cli_speculative_rehearsal(caplog):
    with caplog.at_level("INFO", logger="repro_torch"):
        done = port_serve.main(["--arch", "llama2-7b", "--reduced", "--lcd", "--continuous",
                                "--speculative", "3", "--requests", "3", "--tokens", "6",
                                "--device", "cpu"])
    assert len(done) == 3 and all(len(r.out_tokens) == 6 for r in done)
    text = caplog.text
    assert "LCD draft: clustered 7 tensors" in text and "speculative: {'spec_rounds'" in text
    assert "('draft', 3)" in text and "('verify', 4)" in text
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "llama2-7b", "--reduced", "--speculative", "3",
                         "--device", "cpu"])
