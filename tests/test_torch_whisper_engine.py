"""The audio family (whisper-large-v3) served by the port's engine at
`reduced()`: per-slot state holding the decoder's self K/V and each
request's cross K/V, the encoder run once a request at admission.

* in lockstep with the reference's engine on one schedule with a snapshot
  preemption (LCD weights, the float transform): lengths and every state
  leaf after each step, the traces' keys, the greedy tokens at the end;
* engine = plain greedy: a lone request's tokens equal token-by-token
  `decode_step` over the cross K/V of its frames, in the port and in the
  reference (`tests/test_engine_zoo.py`'s recipe);
* staggered admission = solo bit for bit, a cancelled request's slot reused;
  distinct frames give distinct tokens for one prompt;
* snapshot preemption resumes bit-equal to an unpreempted run without
  re-feeding a token or re-running an encoder;
* `submit`'s refusals, bounded traces with "encode", the capability
  refusals, the CLI.

Tolerances: lengths and tokens exact; state leaves atol 1e-4 + rtol 1e-4
(the standard of `tests/test_torch_whisper.py`)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import engine as ref_engine
from repro.models import whisper as ref_whisper
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve
from repro_torch.models import whisper as port_whisper

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import assert_close, assert_equal, np_of, port_model, reference_model
from test_torch_whisper import ARCH, _frames, pair

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

ECFG = dict(num_slots=3, block_size=4, num_blocks=40, max_blocks_per_slot=10,
            prefill_chunk=8)
SLOT_KEYS = {1, 8, "slot_reset", "encode", "snapshot", "restore"}


@functools.lru_cache(maxsize=None)
def _lcd(seed):
    """(reference model, LCD params with the float transform, port model,
    the port's params)."""
    return pair(seed=seed, variant="lcd_float")


def _requests(cfg, n, seed):
    """n (prompt of 3-13 tokens, frames (1, enc_seq, d)) pairs."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(3, 14))).astype(np.int32),
             _frames(cfg, 1, seed * 100 + i)) for i in range(n)]


def _engine(pmodel, pparams, **kw):
    return port_engine.ServingEngine(pmodel, pparams, port_engine.EngineConfig(**{**ECFG, **kw}),
                                     device="cpu")


def _solo(pmodel, pparams, prompt, frames, new_tokens):
    eng = _engine(pmodel, pparams)
    r = eng.submit(prompt, max_new_tokens=new_tokens, frames=frames)
    eng.run()
    return list(r.out_tokens)


def test_engine_in_lockstep_with_the_reference():
    """The same LCD params, prompts, frames and arrivals (a request every
    other step) through both engines, the first request snapshot-preempted
    in both once it has two tokens: lengths and every state leaf (self and
    cross K/V) after each step, the snapshot's length, the traces' keys and
    encode counts, the greedy tokens at the end."""
    model, params, pmodel, pparams = _lcd(1)
    ref = ref_engine.ServingEngine(model, params, ref_engine.EngineConfig(**ECFG))
    port = _engine(pmodel, pparams)
    pending = _requests(model.cfg, 5, seed=2)
    reqs_r, reqs_p, preempted = [], [], False
    while pending or ref.busy or port.busy:
        if pending and ref.steps % 2 == 0:
            p, f = pending.pop(0)
            reqs_r.append(ref.submit(p, max_new_tokens=6, frames=f))
            reqs_p.append(port.submit(p, max_new_tokens=6, frames=f))
        if not preempted and reqs_r and len(reqs_r[0].out_tokens) == 2:
            ref.preempt(reqs_r[0])
            port.preempt(reqs_p[0])
            preempted = True
            assert reqs_p[0].snap_len == reqs_r[0].snap_len > 0
            assert reqs_p[0].snapshot is not None and reqs_r[0].snapshot is not None
        if ref.busy:
            ref.step()
            port.step()
            assert_equal(port.lengths, ref.lengths, f"step {ref.steps}: lengths")
            for name, want in ref.caches["slot"].items():
                assert_close(np_of(port.caches["slot"][name]), np.asarray(want), rtol=1e-4,
                             atol=1e-4, what=f"step {ref.steps}: slot/{name}")
        else:
            ref.steps += 1
            port.steps += 1
    want = [list(r.out_tokens) for r in reqs_r]
    got = [list(r.out_tokens) for r in reqs_p]
    assert got == want, "tokens diverge from the reference engine's"
    assert preempted and reqs_p[0].preemptions == 1
    assert len({tuple(t) for t in want}) > 1 and all(len(t) == 6 for t in want)
    assert set(port.traces) == set(ref.traces) <= SLOT_KEYS
    assert port.traces["encode"] == 5 and port.traces["restore"] == 1
    port.assert_bounded_traces()


def _plain_greedy(pmodel, pparams, prompt, frames, new_tokens):
    """`tests/test_engine_zoo.py`'s plain decode in the port: the request's
    encoder output, its cross K/V in a batch-1 static cache, the whole
    prompt in one call, then one token a call."""
    cfg = pmodel.cfg
    with torch.no_grad():
        ck, cv = port_whisper.build_cross_cache(
            pparams, port_whisper.encode(pparams, torch.from_numpy(frames), cfg), cfg)
    cache = pmodel.init_cache(1, 64, device="cpu")
    cache["ck"].copy_(ck)
    cache["cv"].copy_(cv)
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


def _ref_plain_greedy(model, params, prompt, frames, new_tokens):
    """The reference's own recipe (`tests/test_engine_zoo.py:60-84`)."""
    cfg = model.cfg
    enc = ref_whisper.encode(params, jnp.asarray(frames), cfg)
    ck, cv = ref_whisper.build_cross_cache(params, enc, cfg)
    cache = dict(ref_whisper.init_cache(cfg, 1, 64), ck=ck, cv=cv)
    step = jax.jit(functools.partial(ref_whisper.decode_step, cfg=cfg))
    lg, cache = step(params, cache, jnp.asarray([prompt], jnp.int32), jnp.int32(0))
    out = [int(jnp.argmax(lg[0, :cfg.vocab]))]
    pos = len(prompt)
    for _ in range(new_tokens - 1):
        lg, cache = step(params, cache, jnp.asarray([[out[-1]]], jnp.int32), jnp.int32(pos))
        out.append(int(jnp.argmax(lg[0, :cfg.vocab])))
        pos += 1
    return out


def test_engine_tokens_equal_plain_greedy():
    """A lone request's engine tokens equal plain greedy decoding's, the
    port's and the reference's (dense params: the reference's own test
    serves the zoo dense)."""
    model, params, pmodel, pparams = pair(seed=5)
    prompt, frames = _requests(model.cfg, 1, seed=6)[0]
    got = _solo(pmodel, pparams, prompt, frames, 6)
    assert got == _plain_greedy(pmodel, pparams, prompt, frames, 6)
    assert got == _ref_plain_greedy(model, params, prompt, frames, 6)


def test_staggered_admission_equals_solo_and_cancel_frees_the_slot():
    """Three requests admitted a step apart, a fourth cancelled mid-stream:
    each finished request's tokens equal its solo run's bit for bit, the
    cancelled one's slot is reused by a later request (its slot state reset
    and re-encoded) that also equals its solo run; one encode per
    admission, and the traces stay bounded."""
    _, _, pmodel, pparams = _lcd(7)
    reqs_in = _requests(pmodel.cfg, 5, seed=8)
    eng = _engine(pmodel, pparams)

    def submit(i, n):
        return eng.submit(reqs_in[i][0], max_new_tokens=n, frames=reqs_in[i][1])
    reqs = [submit(0, 6)]
    eng.step()
    reqs.append(submit(1, 4))
    victim = submit(2, 8)
    eng.step()
    eng.step()
    assert victim.state == "running" and eng.cancel(victim)
    assert victim.state == "cancelled" and victim.slot is None
    reqs.append(submit(3, 5))
    eng.step()
    reqs.append(submit(4, 5))
    eng.run()
    eng.assert_bounded_traces()
    assert set(eng.traces) <= SLOT_KEYS
    assert eng.traces["slot_reset"] == eng.traces["encode"] == 5
    for r, i in zip(reqs, (0, 1, 3, 4)):
        p, f = reqs_in[i]
        assert r.out_tokens == _solo(pmodel, pparams, p, f, r.max_new_tokens), r.rid
    assert not eng.cancel(victim)


def test_distinct_frames_give_distinct_tokens():
    """One prompt with two different frame buffers gives two different token
    streams (the decoder reads each slot's own cross K/V), and with the same
    frames the same stream, in one engine."""
    _, _, pmodel, pparams = _lcd(9)
    cfg = pmodel.cfg
    prompt = np.random.default_rng(10).integers(0, cfg.vocab, 8).astype(np.int32)
    fa, fb = _frames(cfg, 1, 11), _frames(cfg, 1, 12)
    eng = _engine(pmodel, pparams)
    reqs = [eng.submit(prompt, max_new_tokens=8, frames=f) for f in (fa, fb, fa)]
    eng.run()
    assert reqs[0].out_tokens == reqs[2].out_tokens != reqs[1].out_tokens


def test_preemption_resumes_without_recompute_or_reencoding():
    """Two running requests preempted, one mid-prefill and one decoding, then
    drained: every request's tokens equal an unpreempted run's; the slot rows
    (cross K/V among them) are snapshotted and restored, so no token is fed
    twice and no encoder runs again (one encode per request)."""
    _, _, pmodel, pparams = _lcd(13)
    rng = np.random.default_rng(14)
    cfg = pmodel.cfg
    reqs_in = [(rng.integers(0, cfg.vocab, n).astype(np.int32), _frames(cfg, 1, 15 + n))
               for n in (20, 5, 9)]

    def drive(preempt):
        eng = _engine(pmodel, pparams)
        reqs = [eng.submit(p, max_new_tokens=7, frames=f) for p, f in reqs_in]
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
    assert got == want and fed == fed_unpreempted
    assert eng.traces["snapshot"] == eng.traces["restore"] == 2
    assert eng.traces["encode"] == eng.traces["slot_reset"] == 3
    eng.assert_bounded_traces()


def test_submit_refuses_what_the_reference_refuses():
    """`submit` on an encoder-decoder model refuses a missing `frames` and a
    wrong shape, with the reference's messages, and takes (enc_seq, d) or
    (1, enc_seq, d), cast to the model dtype on the engine's device; every
    other family refuses `frames`."""
    _, _, pmodel, pparams = _lcd(1)
    cfg = pmodel.cfg
    eng = _engine(pmodel, pparams)
    with pytest.raises(ValueError, match="is encoder-decoder: submit\\(\\) needs `frames`"):
        eng.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(ValueError, match="frames must be \\(1, 32, 128\\)"):
        eng.submit([1, 2, 3], max_new_tokens=2, frames=np.zeros((2, 32, 128), np.float32))
    with pytest.raises(ValueError, match="frames must be"):
        eng.submit([1, 2, 3], max_new_tokens=2, frames=np.zeros((32, 64), np.float32))
    r = eng.submit([1, 2, 3], max_new_tokens=2, frames=np.ones((32, 128), np.float64))
    assert tuple(r.frames.shape) == (1, cfg.enc_seq, cfg.d_model)
    assert r.frames.dtype == cfg.torch_dtype and r.frames.device.type == "cpu"
    llama = port_model("llama2-7b", n_layers=1)
    other = port_engine.ServingEngine(llama, llama.init(torch.Generator().manual_seed(0),
                                                        device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="has no encoder; submit\\(\\) got unexpected"):
        other.submit([1, 2], max_new_tokens=2, frames=np.zeros((1, 4, 4), np.float32))


def test_engine_config_refuses_what_the_family_lacks():
    """Speculation, the prefix cache and the int8 pool need capabilities the
    audio family lacks (the reference's `tests/test_cache_protocols.py`):
    `EngineConfig(arch=...)` refuses each, naming it, and so does the engine
    for the int8 pool; a mesh is refused as not ported for the family, the
    family named."""
    for kw, cap in ((dict(speculative_k=2), "'speculative'"),
                    (dict(prefix_cache=True), "'prefix_cache'"),
                    (dict(kv_dtype="int8"), "'int8_kv'")):
        with pytest.raises(ValueError, match=cap):
            port_engine.EngineConfig(arch=ARCH, **kw)
    _, _, pmodel, pparams = pair(seed=0)
    with pytest.raises(ValueError, match="int8_kv"):
        port_engine.ServingEngine(pmodel, pparams, port_engine.EngineConfig(kv_dtype="int8"),
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="family 'audio'.*mesh"):
        port_engine.ServingEngine(pmodel, pparams, port_engine.EngineConfig(data_parallel=2),
                                  device="cpu")
    eng = _engine(pmodel, pparams)
    assert eng.kv_dtype == "float" and eng.has_slot and not eng.has_paged


@pytest.mark.parametrize("mode", ["continuous", "describe"])
def test_serve_cli(mode, caplog):
    """`python -m repro_torch.launch.serve --arch whisper-large-v3 --reduced
    --lcd --continuous --device cpu` (the dense weights LCD-compressed
    first, synthetic frames per request), and `--describe` (dense), which
    prints the slot state's bytes."""
    argv = ["--arch", ARCH, "--reduced", "--continuous", "--tokens", "4",
            "--prompt-len", "10", "--requests", "3", "--device", "cpu"]
    argv += ["--describe"] if mode == "describe" else ["--lcd"]
    with caplog.at_level("INFO", logger="repro_torch"):
        out = port_serve.main(argv)
    if mode == "continuous":
        assert len(out) == 3 and all(len(r.out_tokens) == 4 for r in out)
        assert "'encode': 3" in caplog.text
        assert all(r.frames is not None for r in out)
    else:
        state = port_model(ARCH).init_seq_caches(num_blocks=48, block_size=8, num_slots=4,
                                                 max_seq=64, device="cpu")["slot"]
        nbytes = sum(t.numel() * t.element_size() for t in state.values())
        assert f"paged pool bytes 0, slot state bytes {nbytes}" in caplog.text
        assert "params are not LCD-compressed" in caplog.text


def test_reference_model_and_engine_agree_on_the_cli_engine_shape():
    """The reference's `reduced()` whisper and the port's declare the same
    slot-state leaves, shapes and dtypes for the CLI's geometry."""
    model, _ = reference_model(ARCH)
    want = model.init_seq_caches(num_blocks=48, block_size=8, num_slots=4, max_seq=64)["slot"]
    got = port_model(ARCH).init_seq_caches(num_blocks=48, block_size=8, num_slots=4,
                                           max_seq=64, device="cpu")["slot"]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(w.shape), name
    assert port_whisper.SLOT_STATE_NAMES == ref_whisper.SLOT_STATE_NAMES
    assert port_whisper.CACHE_NAMES == ref_whisper.CACHE_NAMES
