"""The compiled step's parts that run without a card: the engine's eager step
body (`ServingEngine._step_body`, what each width's CUDA graph captures) fed
from one buffer per width that is rewritten in place between calls, as the
graphs' static input buffers are; the launch tally a replay adds; and the
guard against params or pools replaced after a capture.

The body is held to fresh `serving_step` calls on freshly made input tensors
and to the reference engine on the same converted params and staggered
arrivals (greedy tokens, block tables: exact; KV pools: exact, since both
sides run the same ops on the same inputs). No CUDA graph runs here: the CPU
has none, and `chip_smoke.py`'s `graph` check holds every replay to this
body on the card."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.launch import engine as ref_engine
from repro_torch.convert import from_reference
from repro_torch.core import clustered_params as port_cp
from repro_torch.kernels import lut_matmul as _lm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import smooth_quant as _sq
from repro_torch.launch import engine as port_engine

from _xfw import (assert_equal, cluster_params, np_of, port_model, reference_model,
                  to_numpy_tree)

pytestmark = pytest.mark.tier1

ECFG = dict(num_slots=3, block_size=4, max_blocks_per_slot=12, prefill_chunk=8)


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(3, 21))).astype(np.int32)
            for _ in range(n)]


class _StaticBuffers:
    """The CPU stand-in of the card's step runner: one upload buffer per
    width, allocated at the width's first step and rewritten in place at
    every later one, fed to the engine's eager body. Each step is also run
    by a fresh `serving_step` call on a shadow copy of the pools, and the two
    must agree exactly."""

    def __init__(self, engine):
        self.engine = engine
        self.bufs = {}
        self.shadow = {k: v.clone() for k, v in engine.caches["paged"].items()}
        self.widths = {}

    def __call__(self, tokens, n_new):
        e = self.engine
        t = tokens.shape[1]
        buf = self.bufs.setdefault(t, torch.empty(e._upload_len(t), dtype=torch.int32))
        e._pack(buf.numpy(), tokens, n_new)
        got = e._step_body(e.caches, buf, t)
        fresh = [torch.from_numpy(np.array(a, np.int32))
                 for a in (tokens, e.lengths, n_new, e.block_tables)]
        logits, _ = e.model.serving_step(e.params, {"paged": self.shadow}, *fresh)
        want = torch.argmax(logits[..., :e.model.cfg.vocab], dim=-1).to(torch.int32)
        assert_equal(np_of(got), np_of(want), f"width {t}: next tokens, body vs fresh call")
        for name, pool in e.caches["paged"].items():
            assert_equal(np_of(pool), np_of(self.shadow[name]), f"width {t}: pool {name}")
        self.widths[t] = self.widths.get(t, 0) + 1
        return np_of(got)


def _drive(engines, prompts, new_tokens):
    """Staggered arrivals into every engine in lockstep: a fresh request
    every other step; the engines' block tables and lengths must agree."""
    pending, requests = list(prompts), [[] for _ in engines]
    lead = engines[0]
    while pending or lead.busy:
        if pending and lead.steps % 2 == 0:
            p = pending.pop(0)
            for e, rs in zip(engines, requests):
                rs.append(e.submit(p, max_new_tokens=new_tokens))
        busy = lead.busy
        for e in engines:
            if busy:
                e.step()
            else:
                e.steps += 1
        for e in engines[1:]:
            assert_equal(e.block_tables, lead.block_tables, "block tables")
            assert_equal(e.lengths, lead.lengths, "slot lengths")
    return requests


@pytest.mark.parametrize("num_blocks", [48, 14], ids=["roomy", "preempting"])
@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
def test_step_body_on_rewritten_buffers_equals_fresh_calls_and_the_reference(kv_dtype,
                                                                            num_blocks):
    """Both widths, float and int8 pools, with and without recompute
    preemption: the body on buffers rewritten in place gives the tokens and
    pools of fresh `serving_step` calls, and the engine's tokens equal the
    reference engine's."""
    arch = "llama2-7b"
    model, dense = reference_model(arch, seed=2)
    params = cluster_params(dense, 4, smooth_seed=5)
    kw = dict(ECFG, num_blocks=num_blocks, kv_dtype=kv_dtype)
    kv_smooth = None
    if kv_dtype == "int8":
        kv_smooth = ref_engine.calibrate_kv_smooth(model, params, n_tokens=16, batch=2)
    ref, _ = ref_engine.build_engine(arch, lcd=True, ecfg=ref_engine.EngineConfig(**kw),
                                     params=params, kv_smooth=kv_smooth,
                                     fused_projections=False)
    port, _ = port_engine.build_engine(
        arch, lcd=True, ecfg=port_engine.EngineConfig(**kw),
        params=from_reference(to_numpy_tree(params), device="cpu"),
        kv_smooth=None if kv_smooth is None else tuple(np_of(s) for s in kv_smooth),
        fused_projections=False, device="cpu")
    assert port._graphs is None, "the CPU runs the eager step"
    port._model_step = buffers = _StaticBuffers(port)
    want, got = _drive([ref, port], _prompts(model.cfg.vocab, 5, seed=6), 8)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert set(buffers.widths) == {1, 8} and min(buffers.widths.values()) > 1
    assert (sum(r.preemptions for r in got) > 0) == (num_blocks < 48)
    assert [r.preemptions for r in got] == [r.preemptions for r in want]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
def test_step_body_fused_and_unfused_on_rewritten_buffers(kv_dtype, fused):
    """The port's own configurations (qwen2-1.5b: GQA, QKV bias), the body
    on rewritten buffers against fresh calls at both widths; fused and
    per-projection launches give the same tokens."""
    model = port_model("qwen2-1.5b", n_layers=2, fused_projections=fused)
    params = port_cp.materialize_clustered(model, torch.Generator().manual_seed(1), nbits=4,
                                           device="cpu")
    ecfg = port_engine.EngineConfig(num_blocks=40, kv_dtype=kv_dtype, **ECFG)
    ones = np.ones((2, model.cfg.n_kv_heads, model.cfg.hd), np.float32)
    smooth = (ones, ones * 1.25) if kv_dtype == "int8" else None
    engine = port_engine.ServingEngine(model, params, ecfg, kv_smooth=smooth, device="cpu")
    engine._model_step = buffers = _StaticBuffers(engine)
    prompts = _prompts(model.cfg.vocab, 4, seed=3)
    requests = _drive([engine], prompts, 6)[0]
    assert set(buffers.widths) == {1, 8}
    other = port_engine.ServingEngine(
        port_model("qwen2-1.5b", n_layers=2, fused_projections=not fused), params, ecfg,
        kv_smooth=smooth, device="cpu")
    assert [r.out_tokens for r in _drive([other], prompts, 6)[0]] == \
        [r.out_tokens for r in requests]


# ---------------------------------------------------------------------------
# the launch tally of a captured step
# ---------------------------------------------------------------------------

@pytest.fixture
def stub_counters(monkeypatch):
    """Fresh counter dicts in place of the kernels' own, for the test."""
    for mod, attr in ((_lm, "LAUNCHES"), (_pa, "LAUNCHES"), (_sq, "LAUNCHES"),
                      (ops, "_FA_LAUNCHES")):
        monkeypatch.setattr(mod, attr, dict.fromkeys(getattr(mod, attr), 0))
    assert set(ops.launch_counts()) == set(_lm.LAUNCHES) | set(_pa.LAUNCHES) | set(
        _sq.LAUNCHES) | set(ops._FA_LAUNCHES)


def _fake_step():
    """What a wrapper does where it launches: one per kernel launch."""
    _lm.LAUNCHES["lut_matmul_fused_multi_gemv"] += 2
    _lm.LAUNCHES["lut_matmul_fused_gemv"] += 2
    _pa.LAUNCHES["paged_pool_attention"] += 1
    return "out"


PER_STEP = {"lut_matmul_fused_multi_gemv": 2, "lut_matmul_fused_gemv": 2,
            "paged_pool_attention": 1}


class _FakeGraph:
    replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.usefixtures("stub_counters")
@pytest.mark.parametrize("replays", [0, 1, 7])
def test_capture_records_the_tally_and_each_replay_adds_it(replays):
    """Warm-up counts once (it launched), the capture records N and counts
    nothing (it launched nothing), K replays add K * N."""
    ops.reset_launch_counts()
    _fake_step()                                              # the warm-up
    with ops.capture_launches() as tally:
        _fake_step()                                          # the capture
    assert tally == PER_STEP
    want = {n: c for n, c in ops.launch_counts().items() if c}
    assert want == PER_STEP, "the capture must leave the counters as the warm-up left them"
    graph = _FakeGraph()
    step = port_engine._CapturedStep(graph, "out", tally, 0.0)
    for _ in range(replays):
        step.replay()
    assert graph.replays == replays
    counts = ops.launch_counts()
    assert {n: c for n, c in counts.items() if c} == {n: (1 + replays) * c
                                                      for n, c in PER_STEP.items()}
    assert counts["flash_attention"] == counts["smooth_quant"] == 0


@pytest.mark.usefixtures("stub_counters")
def test_a_failed_capture_still_takes_its_count_back():
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="capture broke"):
        with ops.capture_launches() as tally:
            _fake_step()
            raise RuntimeError("capture broke")
    assert tally == PER_STEP and not any(ops.launch_counts().values())
    ops.add_launches(tally, 3)
    assert {n: c for n, c in ops.launch_counts().items() if c} == {
        n: 3 * c for n, c in PER_STEP.items()}


# ---------------------------------------------------------------------------
# what a graph reads must not move after its capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("replace", ["params", "param_leaf", "pools", "pool_tensor"])
def test_replacing_what_a_captured_graph_reads_raises(replace):
    model = port_model("llama2-7b", n_layers=1)
    params = port_cp.materialize_clustered(model, torch.Generator().manual_seed(0), nbits=4,
                                           device="cpu")
    engine = port_engine.ServingEngine(model, params, port_engine.EngineConfig(**ECFG),
                                       device="cpu")
    graphs = port_engine._StepGraphs()
    graphs.check_read(engine)                  # the first capture records them
    graphs.check_read(engine)                  # unchanged: fine
    if replace == "params":
        engine.params = dict(params)
        engine.params["embed"] = params["embed"].clone()
    elif replace == "param_leaf":
        attn = params["blocks"]["attn"]
        attn["wq"] = attn["wq"]._replace(codes=attn["wq"].codes.clone())
    elif replace == "pools":
        engine.caches = {"paged": {k: v.clone() for k, v in engine.caches["paged"].items()}}
    else:
        engine.caches["paged"]["k"] = engine.caches["paged"]["k"].clone()
    with pytest.raises(RuntimeError, match="replaced after the step was captured"):
        graphs.check_read(engine)


def test_a_width_record_cannot_be_reassigned():
    rec = port_engine._Upload(torch.zeros(3, dtype=torch.int32),
                              torch.zeros(3, dtype=torch.int32))
    step = port_engine._CapturedStep(_FakeGraph(), None, {}, 0.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        rec.dev = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(dataclasses.FrozenInstanceError):
        step.launches = {}
