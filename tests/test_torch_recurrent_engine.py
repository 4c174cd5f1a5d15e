"""The recurrent and hybrid families served by the port's engine — rwkv6-1.6b
and gla-1.3b through per-slot state, zamba2-1.2b through per-slot state and
a paged pool for its shared attention — at `reduced()`:

* in lockstep with the reference's engine on one schedule with a preemption
  (LCD weights, the float transform): lengths, block tables and every state
  leaf after each step, the greedy tokens at the end;
* engine = plain decode: a one-slot step's logits and state bit for bit
  those of the static `decode_step` at batch 1 fed one token at a time
  (rwkv6, gla; within 1e-5 inside a 3-slot step on the CPU), and the
  greedy tokens of the reference's plain-decode test (a whole prompt, then
  one token a step) for all three, zamba2's being its token-level contract;
* staggered admission = solo, bit for bit; a cancelled request frees its slot
  without disturbing its neighbours;
* snapshot preemption (rwkv6, gla) resumes bit-equal to an unpreempted run
  without recomputing a token; zamba2 preempts by recompute;
* bounded traces with the slot keys, the capability refusals, the CLI.

Tolerances: lengths, block tables and tokens exact; state leaves and pools
atol 1e-4 + rtol 1e-4 (the standard of `tests/test_torch_recurrent.py`)."""
import numpy as np
import pytest
import torch

from repro.launch import engine as ref_engine
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.models import zamba2 as port_zamba2

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import assert_close, assert_equal, np_of, port_model
from test_torch_recurrent import ARCHS, _port_tree, cluster_family, pair

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

ECFG = dict(num_slots=3, block_size=4, num_blocks=40, max_blocks_per_slot=10,
            prefill_chunk=8)
SNAPSHOT_ARCHS = ("rwkv6-1.6b", "gla-1.3b")


def _lcd(arch, seed):
    """(reference model, LCD params with the float transform, port model,
    the port's params)."""
    model, params, pmodel = pair(arch, seed=seed)
    params = cluster_family(model, params, 4, smooth_seed=seed + 1)
    return model, params, pmodel, _port_tree(params)


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(3, 14))).astype(np.int32)
            for _ in range(n)]


def _engine(pmodel, pparams, **kw):
    return port_engine.ServingEngine(pmodel, pparams, port_engine.EngineConfig(**{**ECFG, **kw}),
                                     device="cpu")


def _solo(pmodel, pparams, prompt, new_tokens):
    eng = _engine(pmodel, pparams)
    r = eng.submit(prompt, max_new_tokens=new_tokens)
    eng.run()
    return list(r.out_tokens)


def _state_close(port, ref, what):
    for kind in ref.caches:
        for name, want in ref.caches[kind].items():
            assert_close(np_of(port.caches[kind][name]), np.asarray(want), rtol=1e-4,
                         atol=1e-4, what=f"{what}: {kind}/{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_in_lockstep_with_the_reference(arch):
    """The same LCD params, prompts and arrivals (a request every other
    step) through both engines, with one running request preempted in both
    at the same step (a snapshot for rwkv6 / gla, recompute for zamba2):
    lengths, block tables and every state leaf (zamba2's pools too) after
    each step, the preempted request's snapshot length, the traces' keys,
    and the greedy tokens at the end."""
    model, params, pmodel, pparams = _lcd(arch, seed=1)
    ref = ref_engine.ServingEngine(model, params, ref_engine.EngineConfig(**ECFG))
    port = _engine(pmodel, pparams)
    pending = _prompts(model.cfg.vocab, 5, seed=2)
    reqs_r, reqs_p, preempted = [], [], False
    while pending or ref.busy or port.busy:
        if pending and ref.steps % 2 == 0:
            p = pending.pop(0)
            reqs_r.append(ref.submit(p, max_new_tokens=6))
            reqs_p.append(port.submit(p, max_new_tokens=6))
        if not preempted and reqs_r and len(reqs_r[0].out_tokens) == 2:
            ref.preempt(reqs_r[0])
            port.preempt(reqs_p[0])
            preempted = True
            assert reqs_p[0].snap_len == reqs_r[0].snap_len
            assert (reqs_p[0].snapshot is None) == (reqs_r[0].snapshot is None)
        if ref.busy:
            ref.step()
            port.step()
            assert_equal(port.lengths, ref.lengths, f"step {ref.steps}: lengths")
            assert_equal(port.block_tables, ref.block_tables, f"step {ref.steps}: block tables")
            _state_close(port, ref, f"{arch} step {ref.steps}")
        else:
            ref.steps += 1
            port.steps += 1
    want = [list(r.out_tokens) for r in reqs_r]
    got = [list(r.out_tokens) for r in reqs_p]
    assert got == want, f"{arch}: tokens diverge from the reference engine's"
    assert preempted and reqs_p[0].preemptions == 1
    assert len({tuple(t) for t in want}) > 1 and all(len(t) == 6 for t in want)
    assert set(port.traces) == set(ref.traces)
    port.assert_bounded_traces()


@pytest.mark.parametrize("arch", SNAPSHOT_ARCHS)
def test_a_slot_is_bit_equal_to_plain_decode_at_batch_1(arch):
    """The engine's step over one slot, fed a request one token at a time,
    gives logits torch.equal to the static `decode_step` at batch 1 fed the
    same tokens: both run one recurrence, and the step's in-place masked
    state update and last-token gather add nothing to a slot's bits. In a
    3-slot step (its neighbours busy with other prompts) the same slot is
    within 1e-5: the CPU's f32 products sum a row in another order at
    another row count. On the card every op of the step gives a row the
    same bits at 1 and 8 rows (`chip_smoke.py _row_count_ops`)."""
    _, _, pmodel, pparams = _lcd(arch, seed=3)
    cfg = pmodel.cfg
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (3, 9)).astype(np.int32)
    cache = pmodel.init_cache(1, 16, device="cpu")

    def step(caches, s, t):
        one = torch.ones(s, dtype=torch.int32)
        return pmodel.serving_step(pparams, caches, torch.from_numpy(t), 0 * one, one,
                                   torch.zeros((s, 4), dtype=torch.int32))[0]
    solo, trio = (pmodel.init_seq_caches(num_blocks=4, block_size=4, num_slots=s, max_seq=16,
                                         device="cpu") for s in (1, 3))
    for i in range(tokens.shape[1]):
        want, cache = pmodel.decode(pparams, cache, {"tokens": torch.from_numpy(
            tokens[1:2, i:i + 1]), "pos": i})
        got = step(solo, 1, tokens[1:2, i:i + 1])
        assert torch.equal(got[0], want[0]), f"{arch}: token {i}, one slot"
        got3 = step(trio, 3, tokens[:, i:i + 1])
        assert_close(np_of(got3[1]), np_of(want[0]), atol=1e-5, what=f"{arch}: token {i}")
    for leaf, t in solo["slot"].items():
        assert torch.equal(t, cache[leaf]), leaf


def _plain_greedy(pmodel, pparams, prompt, new_tokens):
    """The reference's plain-decode test in the port: the whole prompt in one
    static call (the chunked form), then one token a step."""
    cfg = pmodel.cfg
    cache = pmodel.init_cache(1, 64, device="cpu")
    lg, cache = pmodel.decode(pparams, cache, {"tokens": torch.from_numpy(prompt[None]),
                                               "pos": 0})
    out = [int(torch.argmax(lg[0, :cfg.vocab]))]
    pos = len(prompt)
    for _ in range(new_tokens - 1):
        lg, cache = pmodel.decode(pparams, cache, {
            "tokens": torch.tensor([[out[-1]]], dtype=torch.int32), "pos": pos})
        out.append(int(torch.argmax(lg[0, :cfg.vocab])))
        pos += 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_plain_decode(arch):
    """The engine's greedy tokens for a lone request equal plain decoding's
    (the reference's `tests/test_engine_zoo.py` contract: exact for every
    arch, the hybrid's promise being token-level)."""
    _, _, pmodel, pparams = _lcd(arch, seed=5)
    prompt = np.random.default_rng(6).integers(0, pmodel.cfg.vocab, 10).astype(np.int32)
    assert _solo(pmodel, pparams, prompt, 6) == _plain_greedy(pmodel, pparams, prompt, 6)


@pytest.mark.parametrize("arch", ARCHS)
def test_staggered_admission_equals_solo_and_cancel_frees_the_slot(arch):
    """Three requests admitted one step apart, a fourth cancelled mid-stream:
    each finished request's tokens equal its solo run's bit for bit, the
    cancelled one's slot is reused by a later request that also equals its
    solo run (its slot state was reset), and the traces stay bounded."""
    _, _, pmodel, pparams = _lcd(arch, seed=7)
    prompts = _prompts(pmodel.cfg.vocab, 5, seed=8)
    eng = _engine(pmodel, pparams)
    reqs = [eng.submit(prompts[0], max_new_tokens=6)]
    eng.step()
    reqs.append(eng.submit(prompts[1], max_new_tokens=4))
    victim = eng.submit(prompts[2], max_new_tokens=8)
    eng.step()
    eng.step()
    assert victim.state == "running" and eng.cancel(victim)
    assert victim.state == "cancelled" and victim.slot is None
    reqs.append(eng.submit(prompts[3], max_new_tokens=5))
    eng.step()
    reqs.append(eng.submit(prompts[4], max_new_tokens=5))
    eng.run()
    eng.assert_bounded_traces()
    assert eng.traces["slot_reset"] == 5             # one per fresh admission
    for r, p in zip(reqs, (prompts[0], prompts[1], prompts[3], prompts[4])):
        assert r.out_tokens == _solo(pmodel, pparams, p, r.max_new_tokens), (arch, r.rid)
    assert not eng.cancel(victim)
    if eng.has_paged:
        assert eng.alloc.num_free == ECFG["num_blocks"]


@pytest.mark.parametrize("arch", ARCHS)
def test_preemption_resumes_the_unpreempted_tokens(arch):
    """Two running requests preempted, one mid-prefill and one decoding, then
    drained: every request's tokens equal an unpreempted run's. rwkv6 / gla
    snapshot the slot's state rows and restore them (nothing re-fed: the
    steps' fed tokens equal the unpreempted run's), zamba2 recomputes (its
    slot protocol declares no snapshot, and it has a paged pool)."""
    _, _, pmodel, pparams = _lcd(arch, seed=9)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, pmodel.cfg.vocab, n).astype(np.int32) for n in (20, 5, 9)]

    def drive(preempt):
        eng = _engine(pmodel, pparams)
        reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
        fed, done = [0], False
        step = eng._model_step

        def counting(tokens, n_new):
            fed[0] += int(n_new.sum())
            return step(tokens, n_new)
        eng._model_step = counting
        while eng.busy:
            if preempt and not done and len(reqs[1].out_tokens) >= 2:
                assert reqs[0].prefilling               # the 20-token prompt, mid-prefill
                eng.preempt(reqs[0])
                eng.preempt(reqs[1])
                done = True
            eng.step()
        return eng, [list(r.out_tokens) for r in reqs], fed[0]

    eng, got, fed = drive(True)
    _, want, fed_unpreempted = drive(False)
    assert got == want
    snap = arch in SNAPSHOT_ARCHS
    assert (fed == fed_unpreempted) if snap else (fed > fed_unpreempted)
    assert eng.traces.get("snapshot", 0) == (2 if snap else 0)
    assert eng.traces.get("restore", 0) == (2 if snap else 0)
    # a fresh admission resets its slot; a restore does not
    assert eng.traces["slot_reset"] == 3 + (0 if snap else 2)
    eng.assert_bounded_traces()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_config_refuses_what_the_family_lacks(arch):
    """Speculation, the prefix cache and the int8 pool need capabilities
    none of the three has: `EngineConfig(arch=...)` refuses each, naming it,
    and so does the engine for the int8 pool; zamba2's pool is float only."""
    for kw, cap in ((dict(speculative_k=2), "'speculative'"),
                    (dict(prefix_cache=True), "'prefix_cache'"),
                    (dict(kv_dtype="int8"), "'int8_kv'")):
        with pytest.raises(ValueError, match=cap):
            port_engine.EngineConfig(arch=arch, **kw)
    _, params, pmodel = pair(arch, seed=0)
    with pytest.raises(ValueError, match="int8_kv"):
        port_engine.ServingEngine(pmodel, _port_tree(params),
                                  port_engine.EngineConfig(kv_dtype="int8"), device="cpu")
    eng = _engine(pmodel, _port_tree(params))
    assert eng.kv_dtype == "float" and eng.has_slot and eng.has_paged == (arch == "zamba2-1.2b")
    if arch == "zamba2-1.2b":
        with pytest.raises(ValueError, match="float' only"):
            port_zamba2.init_paged_cache(pmodel.cfg, 4, 4, "int8", device="cpu")


@pytest.mark.parametrize("mode", ["continuous", "describe"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli(arch, mode, caplog):
    """`python -m repro_torch.launch.serve --arch ARCH --reduced --lcd
    --continuous` on the CPU (the dense weights LCD-compressed first), and
    `--describe`, which prints the slot-state bytes beside the pool bytes."""
    argv = ["--arch", arch, "--reduced", "--lcd", "--continuous", "--tokens", "4",
            "--prompt-len", "10", "--requests", "3", "--device", "cpu"]
    if mode == "describe":
        argv.append("--describe")
    if arch == "gla-1.3b" and mode == "continuous":
        # compress_model clusters the gate LoRA, which then cannot run, in the
        # reference either (ROADMAP C): LCD gla raises; dense gla serves
        with pytest.raises(TypeError):
            port_serve.main(argv)
        argv.remove("--lcd")
    with caplog.at_level("INFO", logger="repro_torch"):
        out = port_serve.main(argv)
    if mode == "continuous":
        assert len(out) == 3 and all(len(r.out_tokens) == 4 for r in out)
        assert "slot_reset" in caplog.text
    else:
        # the CLI's default geometry: 4 slots, 48 blocks of 8 tokens
        caches = port_model(arch, fused_projections=True).init_seq_caches(
            num_blocks=48, block_size=8, num_slots=4, max_seq=64, device="cpu")
        nbytes = {kind: sum(t.numel() * t.element_size() for t in c.values())
                  for kind, c in caches.items()}
        assert (f"paged pool bytes {nbytes.get('paged', 0)}, slot state bytes "
                f"{nbytes['slot']}") in caplog.text
