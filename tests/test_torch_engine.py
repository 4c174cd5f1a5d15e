"""The port's continuous-batching engine: the block allocator in lockstep with
the reference's, EngineConfig's eager errors, what the port refuses,
engine-vs-solo token identity, bounded step widths, recompute preemption, and
greedy-token identity port-vs-reference on reduced llama2-7b and qwen2-1.5b
(float and int8 pools, the reference's calibrated kv_smooth handed over)."""
import collections
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import clustered_params as ref_cp
from repro.launch import engine as ref_engine
from repro_torch.convert import from_reference
from repro_torch.core import clustered_params as port_cp
from repro_torch.core.api import dense_to_clustered, is_clustered
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (assert_equal, cluster_params, np_of, port_model,
                  reference_model, to_numpy_tree, with_act_scale)

pytestmark = pytest.mark.tier1


# ---------------------------------------------------------------------------
# allocator: the reference's and the port's driven by one script, state exact
# ---------------------------------------------------------------------------

def _state(a):
    return (list(a._free), list(a._refcount), list(a._hash_index.items()),
            list(a._block_hash))


def _check_invariants(a, holders, n):
    referenced = sum(1 for b in range(n) if a.refcount(b) > 0)
    assert a.num_free + referenced == n, "conservation"
    for b in range(n):
        indexed = int(a._block_hash[b] is not None
                      and a._hash_index.get(a._block_hash[b]) == b)
        assert a.refcount(b) == holders[b] + indexed
    free = list(a._free)
    assert len(free) == len(set(free)) and all(a.refcount(b) == 0 for b in free)
    assert all(a.refcount(b) >= 1 for b in a._hash_index.values())


@pytest.mark.parametrize("seed", range(8))
def test_allocator_lockstep_with_reference_and_shadow_model(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 13))
    ref, port = ref_engine.BlockAllocator(n), port_engine.BlockAllocator(n)
    holders = collections.Counter()
    for step in range(300):
        op, b = int(rng.integers(0, 5)), int(rng.integers(0, n))
        outs = []
        for a in (ref, port):
            try:
                if op == 0:
                    outs.append(a.alloc(b % 4 + 1))
                elif op == 1:
                    outs.append(a.share(b))
                elif op == 2:
                    outs.append(a.register(b, step // 2))
                elif op == 3:
                    outs.append(a.free([b]) if holders[b] > 0 else "skipped")
                else:
                    outs.append(a.lookup(step // 3))
            except ValueError as e:
                outs.append(f"ValueError: {e}")
        assert outs[0] == outs[1], f"op {op} on block {b}: {outs}"
        if op == 0 and outs[1] is not None:
            holders.update(outs[1])
        elif op == 1 and isinstance(outs[1], int):
            holders[b] += 1
        elif op == 3 and outs[1] is None:
            holders[b] -= 1
        assert _state(ref) == _state(port), "allocator state diverged from the reference"
        _check_invariants(port, holders, n)


def test_allocator_pinned_errors():
    a = port_engine.BlockAllocator(4)
    with pytest.raises(ValueError) as ei:
        a.free([2])
    assert str(ei.value) == ("BlockAllocator.free: block 2 is not allocated "
                             "(double free or refcount underflow)")
    for op, call in (("free", lambda: a.free([4])), ("free", lambda: a.free([-1])),
                     ("share", lambda: a.share(9)), ("register", lambda: a.register(99, 7))):
        with pytest.raises(ValueError) as ei:
            call()
        assert str(ei.value).startswith(f"BlockAllocator.{op}: block id ")
        assert "out of range [0, 4)" in str(ei.value)
    with pytest.raises(ValueError, match="block 0 is free"):
        a.share(0)
    with pytest.raises(ValueError, match="block 0 is free"):
        a.register(0, 123)
    assert a.alloc(5) is None and a.num_free == 4


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

BAD_CONFIGS = [
    dict(kv_dtype="fp8"), dict(weight_bits=5), dict(bits_budget=1.5),
    dict(speculative_k=-1), dict(draft_centroids=1), dict(draft_centroids=17),
    dict(num_blocks=4, max_blocks_per_slot=8), dict(scheduler="lifo"),
    dict(tenant_token_budget=0), dict(tenant_weights={"a": -1.0}),
    dict(data_parallel=0), dict(model_parallel="2"), dict(arch="no-such-arch"),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(kw))
def test_engine_config_value_errors_keep_the_reference_wording(kw):
    with pytest.raises(ValueError) as ref_err:
        ref_engine.EngineConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        port_engine.EngineConfig(**kw)
    want, got = str(ref_err.value), str(port_err.value)
    if "arch" in kw:        # the registered arch lists differ: six transformer archs are ported
        want, got = want.split(";")[0], got.split(";")[0]
    assert got == want


def test_engine_config_fields_and_defaults_match_reference():
    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(ref_engine.EngineConfig)}
    port = {f.name: f.default for f in dataclasses.fields(port_engine.EngineConfig)}
    assert port == ref
    assert port_engine.EngineConfig(block_size=8, max_blocks_per_slot=4).max_seq == 32


UNPORTED = [
    (dict(prefix_cache=True), "prefix_cache"),
    (dict(scheduler="priority"), "scheduler"), (dict(chunked_prefill=True), "chunked_prefill"),
    (dict(data_parallel=2), "data_parallel"), (dict(model_parallel=4), "model_parallel"),
]


@pytest.mark.parametrize("kw,knob", UNPORTED, ids=[k for _, k in UNPORTED])
def test_unported_knobs_raise_not_implemented_naming_the_knob(kw, knob):
    ecfg = port_engine.EngineConfig(**kw)          # valid knobs: constructs fine
    model = port_model("llama2-7b", n_layers=1)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match=knob):
        port_engine.ServingEngine(model, params, ecfg, device="cpu")
    with pytest.raises(NotImplementedError, match=knob):
        port_engine.build_engine("llama2-7b", ecfg=ecfg, device="cpu")


@pytest.mark.usefixtures("one_torch_thread")   # --lcd compresses on the CPU
def test_other_unported_surface():
    import dataclasses
    from repro_torch.models.registry import get_model
    model = port_model("llama2-7b", n_layers=1)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        port_engine.ServingEngine(model, params, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="'moe'"):
        get_model(dataclasses.replace(model.cfg, family="moe"))
    with pytest.raises(ValueError, match="unknown model family"):
        get_model(dataclasses.replace(model.cfg, family="nope"))
    # compress_model is ported: dense params with lcd=True are compressed,
    # and bits_budget without lcd serves the dense weights, as in the reference
    engine, clustered = port_engine.build_engine("llama2-7b", lcd=True, params=params,
                                                 n_layers=1, device="cpu")
    assert engine.compress_report is not None
    assert is_clustered(clustered["blocks"]["mlp"]["w_up"])
    gen, dense = port_engine.serve("llama2-7b", bits_budget=2.5, batch=1, prompt_len=3,
                                   gen_tokens=2, device="cpu")
    assert gen.shape == (1, 2) and not is_clustered(dense["blocks"]["mlp"]["w_up"])
    with pytest.raises(ValueError, match="kv_smooth only applies"):
        port_engine.ServingEngine(model, params, kv_smooth=(1, 1), device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the refusal cannot be shown")
    model = port_model("llama2-7b", n_layers=1)
    with pytest.raises(RuntimeError, match="pass device='cpu' explicitly"):
        port_engine.build_engine("llama2-7b")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_serve.main(["--arch", "llama2-7b", "--reduced", "--continuous"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_serve.main(["--arch", "llama2-7b", "--reduced"])
    with pytest.raises(RuntimeError, match="pass device='cpu' explicitly"):
        port_engine.serve("llama2-7b")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        from_reference({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_engine.ServingEngine(model, {}, None)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_cp.materialize_clustered(model, torch.Generator().manual_seed(0))
    codes = np.zeros((4, 4), np.uint8)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        dense_to_clustered(np.zeros((4, 4), np.float32), codes, np.zeros(16, np.float32))


# ---------------------------------------------------------------------------
# the engine inside the port
# ---------------------------------------------------------------------------

ECFG = dict(num_slots=3, block_size=4, num_blocks=40, max_blocks_per_slot=10,
            prefill_chunk=8)


def _prompts(vocab, n, seed, lo=3, hi=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _drive(engine, prompts, new_tokens):
    """Staggered submissions: a fresh request every other scheduler step."""
    pending, requests = list(prompts), []
    while pending or engine.busy:
        if pending and engine.steps % 2 == 0:
            requests.append(engine.submit(pending.pop(0), max_new_tokens=new_tokens))
        if engine.busy:
            engine.step()
        else:
            engine.steps += 1
    return requests


@pytest.fixture(scope="module")
def lcd_engine_parts():
    model = port_model("llama2-7b", n_layers=2)
    gen = torch.Generator().manual_seed(3)
    params = port_cp.materialize_clustered(model, gen, nbits=4, device="cpu")
    return model, params


def _quantized(params):
    def walk(t):
        if is_clustered(t):
            return with_act_scale(t, 0.05)
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) else t
    return walk(params)


@pytest.mark.parametrize("kv_dtype", ["float", "int8"])
@pytest.mark.parametrize("quantized", [False, True], ids=["float_tf", "quant_tf"])
def test_engine_vs_solo_token_identity_and_bounded_widths(lcd_engine_parts, quantized, kv_dtype):
    model, params = lcd_engine_parts
    if quantized:
        params = _quantized(params)
    ecfg = port_engine.EngineConfig(kv_dtype=kv_dtype, **ECFG)
    ones = np.ones((2, model.cfg.n_kv_heads, model.cfg.hd), np.float32)
    smooth = (ones, ones * 1.5) if kv_dtype == "int8" else None
    prompts = _prompts(model.cfg.vocab, 6, seed=4)
    engine = port_engine.ServingEngine(model, params, ecfg, kv_smooth=smooth, device="cpu")
    requests = _drive(engine, prompts, 6)
    engine.assert_bounded_traces()
    assert set(engine.traces) == {1, 8}, "both step widths must have run"
    assert all(r.state == "finished" and len(r.out_tokens) == 6 for r in requests)
    assert engine.alloc.num_free == ecfg.num_blocks, "every block returned"
    for r, prompt in zip(requests, prompts):
        solo = port_engine.ServingEngine(model, params, ecfg, kv_smooth=smooth, device="cpu")
        s = solo.submit(prompt, max_new_tokens=6)
        solo.run()
        assert s.out_tokens == r.out_tokens, f"request {r.rid}: engine != solo"


def test_assert_bounded_traces_catches_a_foreign_width(lcd_engine_parts):
    model, params = lcd_engine_parts
    engine = port_engine.ServingEngine(model, params, port_engine.EngineConfig(**ECFG),
                                       device="cpu")
    engine.traces[5] = 1
    with pytest.raises(AssertionError, match="unexpected step shapes"):
        engine.assert_bounded_traces()


def test_forced_preemption_resumes_to_the_same_tokens(lcd_engine_parts):
    model, params = lcd_engine_parts
    roomy = port_engine.EngineConfig(**ECFG)
    tight = port_engine.EngineConfig(**{**ECFG, "num_blocks": 12})
    prompts = _prompts(model.cfg.vocab, 4, seed=9, lo=10, hi=18)
    want = [r.out_tokens for r in _drive(
        port_engine.ServingEngine(model, params, roomy, device="cpu"), prompts, 12)]
    engine = port_engine.ServingEngine(model, params, tight, device="cpu")
    requests = _drive(engine, prompts, 12)
    assert sum(r.preemptions for r in requests) > 0, "the pool must be small enough to preempt"
    assert [r.out_tokens for r in requests] == want
    engine.assert_bounded_traces()
    assert engine.alloc.num_free == tight.num_blocks


def test_cancel_streaming_and_submit_bounds(lcd_engine_parts):
    model, params = lcd_engine_parts
    engine = port_engine.ServingEngine(model, params, port_engine.EngineConfig(**ECFG),
                                       device="cpu")
    seen = []
    a = engine.submit([1, 2, 3], 4, on_token=lambda r, t: seen.append((r.rid, t)))
    b = engine.submit([4, 5, 6, 7, 8], 50 - 15)
    with pytest.raises(ValueError, match="engine max_seq is 40"):
        engine.submit(np.arange(30), 11)
    engine.step()
    assert engine.cancel(b) and b.state == "cancelled" and not engine.cancel(b)
    engine.run()
    assert a.state == "finished" and seen == [(a.rid, t) for t in a.out_tokens]
    assert engine.alloc.num_free == 40 and not engine.busy


# ---------------------------------------------------------------------------
# port vs reference
# ---------------------------------------------------------------------------

def _first_divergence(ref_req, port_req):
    for i, (a, b) in enumerate(zip(ref_req.out_tokens, port_req.out_tokens)):
        if a != b:
            return i
    return None


@pytest.mark.parametrize("arch,kv_dtype,num_blocks", [
    ("llama2-7b", "float", 48), ("llama2-7b", "int8", 48), ("qwen2-1.5b", "float", 48),
    ("qwen2-1.5b", "int8", 48), ("llama2-7b", "float", 14)],
    ids=["llama-float", "llama-int8", "qwen-float", "qwen-int8", "llama-float-preempting"])
def test_greedy_tokens_equal_the_reference_engine(arch, kv_dtype, num_blocks):
    """Same converted LCD params, same prompts, same staggered arrivals: the
    two engines must emit the same greedy tokens and walk the same block
    tables. A divergence prints its first step; the reference's own top-2
    logit margin there tells a tie (re-seed) from a fault (fix)."""
    model, dense = reference_model(arch, seed=2)
    params = cluster_params(dense, 4, smooth_seed=5)
    kw = dict(num_slots=3, block_size=4, num_blocks=num_blocks, max_blocks_per_slot=12,
              prefill_chunk=8, kv_dtype=kv_dtype)
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
    prompts = _prompts(model.cfg.vocab, 5, seed=6)
    pending_r, pending_p = list(prompts), list(prompts)
    reqs_r, reqs_p = [], []
    while pending_r or ref.busy or port.busy:
        if pending_r and ref.steps % 2 == 0:
            reqs_r.append(ref.submit(pending_r.pop(0), max_new_tokens=8))
            reqs_p.append(port.submit(pending_p.pop(0), max_new_tokens=8))
        if ref.busy:
            ref.step()
            port.step()
            assert_equal(port.block_tables, ref.block_tables, "block tables")
            assert_equal(port.lengths, ref.lengths, "slot lengths")
            assert list(port.alloc._free) == list(ref.alloc._free), "allocator free list"
        else:
            ref.steps += 1
            port.steps += 1
    for r, p in zip(reqs_r, reqs_p):
        if r.out_tokens != p.out_tokens:
            i = _first_divergence(r, p)
            pytest.fail(f"{arch}/{kv_dtype} request {r.rid}: tokens diverge at generated "
                        f"token {i}: reference {r.out_tokens} vs port {p.out_tokens}; check "
                        f"the reference's top-2 logit margin there before calling it a fault")
    assert [p.preemptions for p in reqs_p] == [r.preemptions for r in reqs_r]
    assert (sum(p.preemptions for p in reqs_p) > 0) == (num_blocks < 48), \
        "the small pool must force recompute preemptions, the roomy one none"
    assert set(port.traces) == set(ref.traces) == {1, 8}
    port.assert_bounded_traces()


# ---------------------------------------------------------------------------
# clustered params, CLI, import hygiene of the engine module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [2, 3, 4])
@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-1.5b"])
def test_materialize_clustered_has_the_reference_shapes(arch, nbits):
    model, _ = reference_model(arch)
    aparams, _, ref_stats = ref_cp.clustered_abstract(model, nbits=nbits)
    pm = port_model(arch)
    shapes, stats = port_cp.clustered_abstract(pm, nbits=nbits)
    assert stats == ref_stats
    params = port_cp.materialize_clustered(pm, torch.Generator().manual_seed(0), nbits,
                                           device="cpu")

    def walk(ref, port, path):
        if isinstance(ref, dict):
            assert sorted(ref) == sorted(port), path
            for k in ref:
                walk(ref[k], port[k], f"{path}/{k}")
        elif isinstance(ref, ref_cp.ClusteredTensor):
            assert is_clustered(port) and port.nbits == ref.nbits == nbits, path
            for f in ("codes", "codebook", "smooth"):
                assert tuple(getattr(port, f).shape) == getattr(ref, f).shape, (path, f)
            assert port.codes.dtype == torch.uint8
            assert bool((port.codebook[..., 1:] >= port.codebook[..., :-1]).all())
        else:
            assert tuple(port.shape) == ref.shape, path
    walk(aparams, params, "")
    leaf = params["blocks"]["mlp"]["w_down"]
    assert leaf.act_scale is None and leaf.inv_scale is None and leaf.packed is None
    assert bool((leaf.smooth == 1).all()) and leaf.smooth.shape[0] == pm.cfg.n_layers


def test_eligibility_rule_matches_reference():
    model, _ = reference_model("qwen2-1.5b")
    pm = port_model("qwen2-1.5b")
    from repro_torch.models.params import iter_table
    flat = jax.tree_util.tree_flatten_with_path(
        model.table, is_leaf=lambda d: hasattr(d, "names"))[0]
    want = {jax.tree_util.keystr(kp): ref_cp._eligible(jax.tree_util.keystr(kp), d)
            for kp, d in flat}
    got = {path: port_cp._eligible(path, d) for path, d in iter_table(pm.table)}
    assert got == want and sum(got.values()) == 7


@pytest.mark.usefixtures("one_torch_thread")   # --lcd compresses on the CPU
def test_serve_cli_runs_on_the_cpu():
    finished = port_serve.main(
        ["--arch", "qwen2-1.5b", "--reduced", "--lcd", "--continuous",
         "--no-fused-projections", "--requests", "4", "--tokens", "5", "--prompt-len", "12",
         "--kv-dtype", "int8", "--bits", "3", "--device", "cpu"])
    assert len(finished) == 4 and all(len(r.out_tokens) == 5 for r in finished)
    # the default configuration (fused projections, calibrated int8 pool): the same tokens
    fused = port_serve.main(
        ["--arch", "qwen2-1.5b", "--reduced", "--lcd", "--continuous", "--requests", "4",
         "--tokens", "5", "--prompt-len", "12", "--kv-dtype", "int8", "--bits", "3",
         "--device", "cpu"])
    assert [r.out_tokens for r in fused] == [r.out_tokens for r in finished]


def test_importing_the_engine_pulls_in_no_jax():
    code = ("import sys; import repro_torch.launch.engine, repro_torch.launch.serve, "
            "repro_torch.convert, repro_torch.kernels._build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', "
            "'triton')]; print(bad); sys.exit(1 if bad else 0)")
    import os
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": src}, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
