"""The port's engine production features against the reference, on the CPU:
prefix caching with copy-on-write block tables, chunked-prefill admission
and the priority / weighted-fair scheduler with tenant budgets.

Within the port, the twins of the reference's `TestPrefixCacheParity`,
`TestChunkedPrefill` and `TestSchedulerAndStreaming`
(tests/test_serving_engine.py): cache on = cache off request for request
(float and int8 pools, with and without speculation), a block-aligned
resubmit copies on write (the copy equal to its source, the source left
alone by the writer, every pool tensor kept for the step graphs), eviction
of a sharer, the salt by kv dtype, chunked = whole prefill, a long prompt
admitted under pool pressure, priority over arrival, a tenant budget that
defers admission. Port = reference in lockstep on one submission schedule:
after every step the block tables, `lengths`, `cache_stats`, the
allocator's free list and cached count and every request's
`cached_tokens` (exact: integer artefacts), and at the end the tokens
(exact on the tiny configuration), with the cache on, with speculation, and
under the priority scheduler with chunked prefill. Python's `hash` is salted
per process and the two packages' salts differ, so block ids, grants and
counters are compared, never hash values.

The model is the reference's tiny engine configuration (2 layers, d_model
64, 4 query heads over 2 kv heads, vocab 256, f32) with head_dim 32 instead
of 16, as in tests/test_torch_speculative.py: the port's paged attention
takes a head dim that is a multiple of 32 on every device."""
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.core import clustered_params as ref_cp
from repro.launch import engine as ref_engine
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.registry import get_model as ref_get_model
from repro_torch.convert import from_reference
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import assert_equal, to_numpy_tree

pytestmark = pytest.mark.tier1

VOCAB = 256
TINY = dict(arch_id="tiny-engine", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=VOCAB, head_dim=32, dtype="float32")
K = 2          # draft tokens per verify round


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
    """The reference's 2-bit self-draft of the tiny model, in both packages."""
    ref, _ = ref_cp.make_draft_params(tiny[1], draft_centroids=4)
    return ref, from_reference(to_numpy_tree(ref), device="cpu")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


PFX = _prompt(99, 8)                      # the shared "system prompt"


def _with_prefix(seed, extra):
    return PFX.copy() if extra == 0 else np.concatenate([PFX, _prompt(seed, extra)])


SMOOTH = (np.full((2, 2, 32), 1.25, np.float32), np.full((2, 2, 32), 0.8, np.float32))


def _port(model, params, draft=None, kv_smooth=None, **kw):
    return port_engine.ServingEngine(model, params, port_engine.EngineConfig(**kw),
                                     draft_params=draft, kv_smooth=kv_smooth, device="cpu")


def _run(engine, specs, stagger=2):
    """Staggered arrivals of (seed, extra, new tokens[, submit kwargs]):
    a request every `stagger` steps; returns the requests in spec order."""
    reqs, pending = [], list(specs)
    while pending or engine.busy:
        if pending and engine.steps % stagger == 0:
            s, extra, g, *kw = pending.pop(0)
            reqs.append(engine.submit(_with_prefix(s, extra), g, **(kw[0] if kw else {})))
        if engine.busy:
            engine.step()
        else:
            engine.steps += 1         # idle tick: let the next arrival land
    engine.assert_bounded_traces()
    return reqs


def _tokens(reqs):
    return [list(r.out_tokens) for r in reqs]


def _int8(kv_dtype):
    return SMOOTH if kv_dtype == "int8" else None


# ---------------------------------------------------------------------------
# prefix cache on = off, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
def test_staggered_shared_prefix_cache_on_equals_off(tiny, kv_dtype):
    """The hard contract: cache on gives the same tokens as cache off for
    every request within a kv dtype. Sharing and COW are bookkeeping; the
    model step never learns the cache exists."""
    _, _, model, params = tiny
    base = dict(num_slots=3, block_size=4, num_blocks=32, max_blocks_per_slot=8,
                prefill_chunk=8, kv_dtype=kv_dtype)
    specs = [(1, 3, 5), (2, 0, 5), (3, 6, 4), (4, 1, 5), (5, 0, 4)]
    off = _tokens(_run(_port(model, params, kv_smooth=_int8(kv_dtype), **base), specs))
    eng = _port(model, params, kv_smooth=_int8(kv_dtype), prefix_cache=True, **base)
    on = _run(eng, specs)
    assert _tokens(on) == off
    rep = eng.prefix_cache_report()
    assert rep["cached_tokens"] > 0 and rep["block_reuse_rate"] > 0
    assert rep["cached_tokens"] == sum(r.cached_tokens for r in on)
    assert eng.alloc.num_free + eng.alloc.num_cached == base["num_blocks"]


def _spy_cow(engine, seen):
    """Wrap `engine._cow_copy`: right after each copy, whether the new block
    equals its source in every pool tensor it copies, and a clone of the
    source for the later check that the writer left it alone."""
    inner = engine._cow_copy

    def spy(src, dst):
        inner(src, dst)
        for tag, caches in (("", engine.caches), ("draft ", engine.draft_caches)):
            if caches is None:
                continue
            pool = caches["paged"]
            for name in ("k", "v", "k_scale", "v_scale"):
                if name in pool:
                    seen["equal_after_copy"].append(
                        torch.equal(pool[name][:, dst], pool[name][:, src]))
                    seen["sources"].append((tag + name, src, pool[name][:, src].clone()))
    engine._cow_copy = spy


def _sources_unchanged(engine, seen):
    out = []
    for tag_name, src, before in seen["sources"]:
        caches = engine.draft_caches if tag_name.startswith("draft ") else engine.caches
        out.append(torch.equal(caches["paged"][tag_name.split()[-1]][:, src], before))
    return out


@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
def test_block_aligned_resubmit_hits_cow(tiny, kv_dtype):
    """Resubmitting a block-aligned cached prompt re-feeds its last token
    into a SHARED block: the write copies on write first. The copy equals
    its source right after it (codes and the int8 pool's scales), the source
    is untouched by the writer's step, the pool tensors are the same objects
    (what the step graphs read), and the tokens match the cache-off run."""
    _, _, model, params = tiny
    base = dict(num_slots=2, block_size=4, num_blocks=32, max_blocks_per_slot=8,
                prefill_chunk=8, kv_dtype=kv_dtype)
    specs = [(1, 0, 4), (1, 0, 4)]     # identical 8-token (2-block) prompt
    off = _tokens(_run(_port(model, params, kv_smooth=_int8(kv_dtype), **base), specs, 50))
    eng = _port(model, params, kv_smooth=_int8(kv_dtype), prefix_cache=True, **base)
    graphs = port_engine._StepGraphs()
    graphs.check_read(eng)             # what a capture would have recorded
    seen = dict(equal_after_copy=[], sources=[])
    _spy_cow(eng, seen)
    on = _run(eng, specs, 50)
    assert _tokens(on) == off
    assert eng.cache_stats["cow_copies"] >= 1 and eng.traces["cow"] == eng.cache_stats["cow_copies"]
    assert on[1].cached_tokens == 7    # capped at len(feed) - 1
    assert seen["equal_after_copy"] and all(seen["equal_after_copy"])
    assert len(seen["equal_after_copy"]) == (4 if kv_dtype == "int8" else 2) * eng.traces["cow"]
    assert all(_sources_unchanged(eng, seen))
    graphs.check_read(eng)             # raises if a pool tensor was replaced


def test_cow_is_allowed_only_with_the_cache_on(tiny):
    _, _, model, params = tiny
    eng = _port(model, params)
    eng.traces["cow"] = 1
    with pytest.raises(AssertionError, match="unexpected step shapes"):
        eng.assert_bounded_traces()
    eng = _port(model, params, prefix_cache=True)
    eng.traces.update({"cow": 3, 1: 2, 16: 1})
    eng.assert_bounded_traces()


def test_eviction_of_sharer_leaves_other_sharers_intact(tiny):
    """Pool pressure evicts a request that holds SHARED blocks: refcounts keep
    the survivor's blocks alive, both finish with the cache-off tokens, and
    after the drain every block is free or cached."""
    _, _, model, params = tiny
    base = dict(num_slots=2, block_size=2, num_blocks=8, max_blocks_per_slot=8,
                prefill_chunk=4)
    specs = [(0, 0, 6), (0, 0, 6)]     # 14 tokens each: 14 of the 8 blocks
    off = _tokens(_run(_port(model, params, **base), specs))
    eng = _port(model, params, prefix_cache=True, **base)
    on = _run(eng, specs)
    assert _tokens(on) == off
    assert sum(r.preemptions for r in on) >= 1
    assert eng.alloc.num_free + eng.alloc.num_cached == base["num_blocks"]


@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
def test_speculative_composes_with_prefix_cache(tiny, drafts, kv_dtype):
    """Speculation with the cache on gives the plain cache-off tokens; the
    bare prefix resubmitted last forces a COW in both pools (the two-model
    prefill step writes both)."""
    _, _, model, params = tiny
    base = dict(num_slots=2, block_size=4, num_blocks=32, max_blocks_per_slot=8,
                prefill_chunk=8, kv_dtype=kv_dtype)
    specs = [(1, 0, 5), (2, 3, 5), (1, 0, 5)]

    def run(eng):
        out = []
        for s, extra, g in specs:
            r = eng.submit(_with_prefix(s, extra), g)
            eng.run()
            out.append(list(r.out_tokens))
        eng.assert_bounded_traces()
        return out

    smooth = _int8(kv_dtype)
    off = run(_port(model, params, kv_smooth=smooth, **base))
    eng = _port(model, params, drafts[1], kv_smooth=smooth, prefix_cache=True,
                speculative_k=K, **base)
    seen = dict(equal_after_copy=[], sources=[])
    _spy_cow(eng, seen)
    assert run(eng) == off
    assert eng.prefix_cache_report()["cached_tokens"] > 0 and eng.cache_stats["cow_copies"] >= 1
    assert any(name.startswith("draft ") for name, _, _ in seen["sources"])
    assert all(seen["equal_after_copy"]) and all(_sources_unchanged(eng, seen))
    assert eng.alloc.num_free + eng.alloc.num_cached == base["num_blocks"]


def test_cache_salted_by_kv_dtype(tiny):
    """The same tokens under another kv dtype hash to other index entries: an
    int8 pool never serves a float request's blocks."""
    _, _, model, params = tiny
    e_f = _port(model, params, prefix_cache=True)
    e_i = _port(model, params, prefix_cache=True, kv_dtype="int8")
    assert e_f._prefix_salt != e_i._prefix_salt
    assert e_f._chunk_hash(e_f._prefix_salt, PFX[:4]) != e_i._chunk_hash(e_i._prefix_salt, PFX[:4])


def test_preempt_recomputes_from_the_cache_to_the_same_tokens(tiny):
    """`preempt` is recompute preemption: the request goes back to the queue
    front with its blocks and hash chain dropped, re-admission takes its
    prefix from the cache, and the tokens are those of an undisturbed run."""
    _, _, model, params = tiny
    base = dict(num_slots=2, block_size=4, num_blocks=32, max_blocks_per_slot=8,
                prefill_chunk=8)
    want = _tokens(_run(_port(model, params, **base), [(3, 5, 8)]))
    eng = _port(model, params, prefix_cache=True, **base)
    r = eng.submit(_with_prefix(3, 5), 8)
    while len(r.out_tokens) < 3:
        eng.step()
    eng.preempt(r)
    assert r.state == "queued" and eng.queue[0] is r and r.hash_chain == [] and not r.blocks
    assert r.preemptions == 1 and eng._tenant_inflight["default"] == 0
    with pytest.raises(ValueError, match="cannot preempt a 'queued' request"):
        eng.preempt(r)
    eng.run()
    assert [list(r.out_tokens)] == want and r.cached_tokens == 12


# ---------------------------------------------------------------------------
# chunked prefill, the scheduler
# ---------------------------------------------------------------------------

def test_chunked_matches_whole_prefill(tiny):
    _, _, model, params = tiny
    base = dict(num_slots=2, block_size=4, num_blocks=16, max_blocks_per_slot=8,
                prefill_chunk=4)
    p = _prompt(7, 20)

    def solo(**kw):
        eng = _port(model, params, **base, **kw)
        r = eng.submit(p, 6)
        eng.run()
        return list(r.out_tokens)
    assert solo(chunked_prefill=True) == solo()


def test_long_prompt_admitted_under_pool_pressure(tiny):
    """Chunked prefill admits with one chunk's worth of blocks instead of the
    whole prompt's: a long prompt starts while a hog holds most of the pool,
    and decodes as it would alone."""
    _, _, model, params = tiny
    base = dict(num_slots=2, block_size=4, num_blocks=8, max_blocks_per_slot=8,
                prefill_chunk=4)
    eng = _port(model, params, chunked_prefill=True, **base)
    eng.submit(_prompt(6, 8), 9)       # grows to 5 of the 8 blocks
    eng.step()
    late = eng.submit(_prompt(7, 20), 4)   # the whole prompt would need 5
    eng.step()
    assert late.slot is not None and len(late.blocks) == 1
    eng.run()
    solo = _port(model, params, **base)
    r = solo.submit(_prompt(7, 20), 4)
    solo.run()
    assert late.out_tokens == r.out_tokens


def test_priority_beats_arrival_order(tiny):
    _, _, model, params = tiny
    eng = _port(model, params, num_slots=1, block_size=4, num_blocks=16,
                max_blocks_per_slot=4, prefill_chunk=8, scheduler="priority")
    eng.submit(_prompt(1, 4), 3)
    eng.step()                         # occupies the only slot
    low = eng.submit(_prompt(2, 4), 3, priority=0)
    high = eng.submit(_prompt(3, 4), 3, priority=5)
    eng.run()
    assert high.finish_t < low.finish_t
    fcfs = _port(model, params, num_slots=1, block_size=4, num_blocks=16,
                 max_blocks_per_slot=4, prefill_chunk=8)
    fcfs.submit(_prompt(1, 4), 3)
    fcfs.step()
    low = fcfs.submit(_prompt(2, 4), 3, priority=0)
    high = fcfs.submit(_prompt(3, 4), 3, priority=5)
    fcfs.run()
    assert low.finish_t < high.finish_t    # "fcfs" ignores priorities


def test_tenant_budget_defers_admission(tiny):
    _, _, model, params = tiny
    eng = _port(model, params, num_slots=2, block_size=4, num_blocks=32,
                max_blocks_per_slot=8, prefill_chunk=8, scheduler="priority",
                tenant_token_budget=12)
    a = eng.submit(_prompt(1, 4), 6, tenant="t")   # 10 inflight tokens
    b = eng.submit(_prompt(2, 4), 6, tenant="t")   # would exceed 12
    c = eng.submit(_prompt(3, 4), 6, tenant="u")   # other tenant: fine
    eng.step()
    assert a.slot is not None and c.slot is not None and b.slot is None
    assert eng._tenant_inflight == {"t": 10, "u": 10}
    eng.run()
    assert b.state == "finished"       # admitted once a released its tokens
    assert eng._tenant_inflight == {"t": 0, "u": 0}
    assert eng._tenant_served == {"t": 12, "u": 6}


def test_weighted_fair_share_breaks_priority_ties(tiny):
    """Equal priorities: the tenant with the smaller served / weight share
    goes first, whatever the arrival order."""
    _, _, model, params = tiny
    eng = _port(model, params, num_slots=1, block_size=4, num_blocks=16,
                max_blocks_per_slot=4, prefill_chunk=8, scheduler="priority",
                tenant_weights={"a": 1.0, "b": 4.0})
    first = eng.submit(_prompt(1, 4), 4, tenant="b")
    eng.run()                          # b has served 4 tokens: share 1.0
    eng._tenant_served["a"] = 2        # a's share: 2.0
    ra = eng.submit(_prompt(2, 4), 3, tenant="a")
    rb = eng.submit(_prompt(3, 4), 3, tenant="b")
    assert eng._pick_next() is rb
    eng.run()
    assert first.state == ra.state == rb.state == "finished" and rb.finish_t < ra.finish_t


# ---------------------------------------------------------------------------
# port = reference, step by step
# ---------------------------------------------------------------------------

def _state(engine, reqs):
    return dict(block_tables=engine.block_tables.copy(), lengths=engine.lengths.copy(),
                cache_stats=dict(engine.cache_stats), free=list(engine.alloc._free),
                cached=engine.alloc.num_cached,
                refcounts=list(engine.alloc._refcount),
                cached_tokens=[r.cached_tokens for r in reqs],
                states=[(r.state, r.slot, r.preemptions) for r in reqs],
                inflight=dict(engine._tenant_inflight), served=dict(engine._tenant_served))


def _lockstep(ref, port, specs, stagger=2):
    """Both engines fed one submission schedule; their integer state equal
    after every step. Returns (reference requests, port requests, steps)."""
    pending, reqs_r, reqs_p, steps = list(specs), [], [], 0
    while pending or ref.busy or port.busy:
        if pending and ref.steps % stagger == 0:
            s, extra, g, *kw = pending.pop(0)
            kw = kw[0] if kw else {}
            reqs_r.append(ref.submit(_with_prefix(s, extra), g, **kw))
            reqs_p.append(port.submit(_with_prefix(s, extra), g, **kw))
        if ref.busy:
            ref.step()
            port.step()
            steps += 1
            want, got = _state(ref, reqs_r), _state(port, reqs_p)
            for key in want:
                if isinstance(want[key], np.ndarray):
                    assert_equal(got[key], want[key], f"step {steps}: {key}")
                else:
                    assert got[key] == want[key], f"step {steps}: {key}"
        else:
            ref.steps += 1
            port.steps += 1
    return reqs_r, reqs_p, steps


LOCKSTEP_SPECS = [(1, 3, 5), (2, 0, 5), (3, 6, 4), (4, 1, 6), (5, 0, 4), (6, 9, 5),
                  (2, 0, 3)]


@pytest.mark.parametrize("case", ["cache", "cache_preempting", "cache_int8"])
def test_prefix_cache_lockstep_with_the_reference(tiny, case):
    ref_model, ref_params, model, params = tiny
    kw = dict(num_slots=3, block_size=4, num_blocks=32, max_blocks_per_slot=8,
              prefill_chunk=8, prefix_cache=True)
    if case == "cache_preempting":
        kw["num_blocks"] = 8
    smooth = None
    if case == "cache_int8":
        kw["kv_dtype"] = "int8"
        smooth = SMOOTH
    ref = ref_engine.ServingEngine(ref_model, ref_params, ref_engine.EngineConfig(**kw),
                                   kv_smooth=smooth)
    port = _port(model, params, kv_smooth=smooth, **kw)
    reqs_r, reqs_p, _ = _lockstep(ref, port, LOCKSTEP_SPECS)
    assert _tokens(reqs_p) == _tokens(reqs_r)
    assert port.prefix_cache_report() == ref.prefix_cache_report()
    assert set(port.traces) == set(ref.traces) and "cow" in port.traces
    assert port.cache_stats["cow_copies"] >= 1 and port.cache_stats["shared_block_grants"] > 0
    assert (sum(r.preemptions for r in reqs_p) > 0) == (case == "cache_preempting")
    port.assert_bounded_traces()


def test_speculative_prefix_cache_lockstep_with_the_reference(tiny, drafts):
    ref_model, ref_params, model, params = tiny
    kw = dict(num_slots=3, block_size=4, num_blocks=32, max_blocks_per_slot=8,
              prefill_chunk=8, prefix_cache=True, speculative_k=K)
    ref = ref_engine.ServingEngine(ref_model, ref_params, ref_engine.EngineConfig(**kw),
                                   draft_params=drafts[0])
    port = _port(model, params, drafts[1], **kw)
    reqs_r, reqs_p, _ = _lockstep(ref, port, LOCKSTEP_SPECS)
    assert _tokens(reqs_p) == _tokens(reqs_r)
    assert [r.accept_lens for r in reqs_p] == [r.accept_lens for r in reqs_r]
    assert port.prefix_cache_report() == ref.prefix_cache_report()
    assert port.spec_rounds == ref.spec_rounds and port.cache_stats["cow_copies"] >= 1
    assert set(port.traces) == set(ref.traces)


SCHED_SPECS = [(1, 3, 5, dict(tenant="a", priority=0)), (2, 9, 4, dict(tenant="b", priority=1)),
               (3, 6, 4, dict(tenant="a", priority=2)), (4, 14, 6, dict(tenant="b", priority=0)),
               (5, 0, 4, dict(tenant="a", priority=1)), (6, 11, 5, dict(tenant="b", priority=2)),
               (7, 2, 3, dict(tenant="a", priority=0)), (8, 5, 4, dict(tenant="b", priority=1))]


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["no_cache", "cache"])
def test_priority_chunked_lockstep_with_the_reference(tiny, prefix_cache):
    """The priority scheduler with two weighted tenants under a token budget
    that defers admissions, chunked-prefill admission, and a pool small
    enough to preempt: the same picks, grants and tokens as the reference."""
    ref_model, ref_params, model, params = tiny
    kw = dict(num_slots=3, block_size=4, num_blocks=10, max_blocks_per_slot=8,
              prefill_chunk=4, chunked_prefill=True, scheduler="priority",
              tenant_weights={"a": 1.0, "b": 2.0}, tenant_token_budget=40,
              prefix_cache=prefix_cache)
    ref = ref_engine.ServingEngine(ref_model, ref_params, ref_engine.EngineConfig(**kw))
    port = _port(model, params, **kw)
    order_r, order_p, deferred = [], [], []
    for eng, order in ((ref, order_r), (port, order_p)):
        inner = eng._tenant_acquire

        def acquire(r, inner=inner, order=order):
            order.append(r.rid)
            inner(r)
        eng._tenant_acquire = acquire
    pick = port._pick_next

    def counted_pick():
        r = pick()
        deferred.append(r is None and bool(port.queue))
        return r
    port._pick_next = counted_pick
    reqs_r, reqs_p, _ = _lockstep(ref, port, SCHED_SPECS, stagger=1)
    assert order_p == order_r and order_p != sorted(order_p)
    assert _tokens(reqs_p) == _tokens(reqs_r)
    assert sum(r.preemptions for r in reqs_p) > 0 and any(deferred)
    assert port._tenant_served == ref._tenant_served == {"a": 16, "b": 19}


# ---------------------------------------------------------------------------
# surface: fields, signatures, report keys, build_engine, the CLI
# ---------------------------------------------------------------------------

def test_request_fields_and_defaults_match_the_reference():
    def fields(cls):
        return {f.name: (f.default, f.default_factory) for f in dataclasses.fields(cls)}
    assert fields(port_engine.Request) == fields(ref_engine.Request)
    assert [f.name for f in dataclasses.fields(port_engine.Request)] == [
        f.name for f in dataclasses.fields(ref_engine.Request)]


def test_submit_and_preempt_signatures_match_the_reference():
    ref = inspect.signature(ref_engine.ServingEngine.submit).parameters
    port = inspect.signature(port_engine.ServingEngine.submit).parameters
    assert list(ref) == list(port)
    assert all(port[p].default == ref[p].default and port[p].kind == ref[p].kind
               for p in port)
    assert (list(inspect.signature(port_engine.ServingEngine.preempt).parameters)
            == list(inspect.signature(ref_engine.ServingEngine.preempt).parameters))


def test_prefix_cache_report_keys_match_the_reference(tiny):
    ref_model, ref_params, model, params = tiny
    ref = ref_engine.ServingEngine(ref_model, ref_params, ref_engine.EngineConfig())
    port = _port(model, params)
    assert port.prefix_cache_report() == ref.prefix_cache_report()
    assert list(port.cache_stats) == list(ref.cache_stats)


def test_build_engine_serves_the_three_knobs():
    ecfg = port_engine.EngineConfig(num_slots=2, block_size=4, num_blocks=32,
                                    max_blocks_per_slot=8, prefill_chunk=8,
                                    prefix_cache=True, chunked_prefill=True,
                                    scheduler="priority", tenant_token_budget=64)
    engine, _ = port_engine.build_engine("llama2-7b", ecfg=ecfg, n_layers=1, device="cpu")
    a = engine.submit(_with_prefix(1, 5), 3, tenant="x", priority=1)
    engine.run()
    b = engine.submit(_with_prefix(2, 6), 3, tenant="y")
    engine.run()
    assert a.state == b.state == "finished" and b.cached_tokens == 8
    engine.assert_bounded_traces()


@pytest.mark.usefixtures("one_torch_thread")   # --lcd compresses on the CPU
def test_cli_prefix_cache_priority_chunked_on_the_cpu(caplog):
    argv = ["--arch", "llama2-7b", "--reduced", "--lcd", "--continuous", "--requests", "5",
            "--tokens", "6", "--device", "cpu"]
    with caplog.at_level("INFO", logger="repro_torch"):
        done = port_serve.main(argv + ["--prefix-cache", "--priority", "--chunked-prefill"])
    assert len(done) == 5 and all(len(r.out_tokens) == 6 for r in done)
    assert {r.tenant for r in done} == {"tenant0", "tenant1"}
    assert sorted(r.priority for r in done) == [0, 0, 1, 1, 2]
    assert "prefix cache: {'cached_tokens'" in caplog.text
    assert sum(r.cached_tokens for r in done) > 0


@pytest.mark.parametrize("flag", ["--prefix-cache", "--chunked-prefill", "--priority"])
def test_cli_engine_flags_need_continuous(flag, capsys):
    with pytest.raises(SystemExit):
        port_serve.main(["--arch", "llama2-7b", "--reduced", flag, "--device", "cpu"])
    assert f"{flag} applies to the paged engine; add --continuous" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# chip_smoke.py's host replay of the scheduler, held to the reference's
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", range(4))
def test_chip_smoke_reference_pick_equals_the_reference_scheduler(tiny, seed):
    """`chip_smoke.py serve_sched` holds every pick on the card to
    `_reference_pick`, the reference's rule re-stated without JAX: on random
    queues and tenant states it picks what the reference engine's
    `_pick_next` picks."""
    ref_model, ref_params, _, _ = tiny
    cs = _chip_smoke()
    rng = np.random.default_rng(seed)
    weights, budget = {"a": 1.0, "b": 2.0, "c": 0.5}, int(rng.integers(40, 120))
    ref = ref_engine.ServingEngine(ref_model, ref_params, ref_engine.EngineConfig(
        scheduler="priority", tenant_weights=weights, tenant_token_budget=budget))
    port_reqs = []
    for i in range(10):
        prompt = _prompt(seed * 100 + i, int(rng.integers(3, 30)))
        kw = dict(tenant="abc"[int(rng.integers(0, 3))], priority=int(rng.integers(0, 3)))
        g = int(rng.integers(1, 20))
        r = ref.submit(prompt, g, **kw)
        r.out_tokens = [1] * int(rng.integers(0, g))   # some already generated (a preemption)
        p = port_engine.Request(r.rid, prompt, g, **kw)
        p.out_tokens = list(r.out_tokens)
        port_reqs.append(p)
    for trial in range(20):
        inflight = {t: int(rng.integers(0, budget)) for t in "abc"}
        served = {t: int(rng.integers(0, 50)) for t in "abc"}
        ref._tenant_inflight, ref._tenant_served = dict(inflight), dict(served)
        want = ref._pick_next()
        got = cs._reference_pick(port_reqs, inflight, served, weights, budget)
        assert (None if got is None else got.rid) == (None if want is None else want.rid)


def test_chip_smoke_first_wave_equals_the_reference_admission(tiny):
    """`chip_smoke.py _first_wave` replays a burst's first admissions on the
    host; the reference engine's first `_admit` over the same burst admits
    the same requests in the same order."""
    ref_model, ref_params, _, _ = tiny
    cs = _chip_smoke()
    ecfg = ref_engine.EngineConfig(num_slots=5, block_size=4, num_blocks=64,
                                   max_blocks_per_slot=16, prefill_chunk=8,
                                   chunked_prefill=True, scheduler="priority",
                                   tenant_weights={"a": 1.0, "b": 2.0}, tenant_token_budget=60)
    ref = ref_engine.ServingEngine(ref_model, ref_params, ecfg)
    order = []
    inner = ref._tenant_acquire

    def acquire(r):
        order.append(r.rid)
        inner(r)
    ref._tenant_acquire = acquire
    rng = np.random.default_rng(5)
    reqs = [ref.submit(_prompt(i, int(rng.integers(4, 40))), 8, tenant="ab"[i % 2],
                       priority=i % 3) for i in range(10)]
    ref._admit()
    want = cs._first_wave(reqs, ecfg.num_slots, 60)
    assert order == want and 0 < len(order) <= ecfg.num_slots and order != sorted(order)
