"""The MoE family served by the port's engine, in lockstep with the
reference's engine on one submission schedule: reduced phi3.5-moe-42b-a6.6b
and llama4-scout-17b-a16e (2 layers, 4 experts), LCD weights with the
experts clustered too (the float transform), the prefix cache on.

An MoE layer routes every token of a step together, the idle slots' pad
tokens included, and drops a token past its expert's capacity, so a
request's tokens depend on what shares its steps: engine = solo,
speculative = plain greedy and cache on = cache off are not contracts of
the reference for this family (its own `tests/test_models.py` bounds
forward against decode by 1.0 for MoE). The contract is the reference's
engine under the same schedule: after every step the block tables and
lengths equal (exact), and at the end the greedy tokens (exact), in plain,
int8 and speculative (k = 3) modes. Also the CLI in both modes."""
import numpy as np
import pytest

from repro.core import clustered_params as ref_cp
from repro.launch import engine as ref_engine
from repro_torch.launch import engine as port_engine
from repro_torch.launch import serve as port_serve

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import assert_equal, cluster_params, port_model, reference_model
from test_torch_family import _lively
from test_torch_moe import _port_tree, cluster_moe

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
ECFG = dict(num_slots=3, block_size=4, num_blocks=40, max_blocks_per_slot=10,
            prefill_chunk=8, prefix_cache=True)


def _prompts(vocab, n, seed):
    """`n` prompts, most opening with one shared 8-token prefix (two blocks)."""
    rng = np.random.default_rng(seed)
    pfx = rng.integers(0, vocab, 8).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(2, 14))).astype(np.int32)
        out.append(tail if i == 2 else np.concatenate([pfx, tail]))
    return out


def _lockstep(ref, port, prompts, new_tokens):
    """Both engines fed one staggered schedule (a request every other
    step); block tables and lengths equal after every step. Returns both
    sides' tokens."""
    pending, reqs_r, reqs_p = list(prompts), [], []
    while pending or ref.busy or port.busy:
        if pending and ref.steps % 2 == 0:
            p = pending.pop(0)
            reqs_r.append(ref.submit(p, max_new_tokens=new_tokens))
            reqs_p.append(port.submit(p, max_new_tokens=new_tokens))
        if ref.busy:
            ref.step()
            port.step()
            assert_equal(port.block_tables, ref.block_tables, f"step {ref.steps}: block tables")
            assert_equal(port.lengths, ref.lengths, f"step {ref.steps}: lengths")
        else:
            ref.steps += 1
            port.steps += 1
    return [list(r.out_tokens) for r in reqs_r], [list(r.out_tokens) for r in reqs_p]


def _smooth(cfg):
    ones = np.ones((cfg.n_layers, cfg.n_kv_heads, cfg.hd), np.float32)
    return ones * 1.25, ones * 0.8


@pytest.mark.parametrize("arch,mode", [(PHI, "plain"), (PHI, "int8"), (PHI, "speculative"),
                                       (SCOUT, "plain"), (SCOUT, "int8"),
                                       (SCOUT, "speculative")])
def test_greedy_tokens_equal_the_reference_engine_in_lockstep(arch, mode):
    """The same converted LCD params, prompts and arrivals through both
    engines with the prefix cache on: the same block tables and lengths
    after every step and the same greedy tokens. The speculative target
    clusters the attention and keeps the experts dense (what
    `compress_model` gives: the reference's draft builder resolves dense
    leaves and (L, ...) clustered ones, not an (L, E) stack); its 2-bit
    draft is the reference's, converted."""
    model, dense = reference_model(arch, seed=2, n_layers=2)
    dense = _lively(dense, 9)
    kw, port_kw, ref_kw = dict(ECFG), {}, {}
    if mode == "speculative":
        mlp = dense["blocks"]["mlp"]
        params = cluster_params({**dense, "blocks": {**dense["blocks"], "mlp": {}}}, 4,
                                smooth_seed=5)
        params["blocks"]["mlp"] = mlp
        draft, _ = ref_cp.make_draft_params(params, draft_centroids=4)
        kw["speculative_k"] = 3
        ref_kw["draft_params"], port_kw["draft_params"] = draft, _port_tree(draft)
    else:
        params = cluster_moe(dense, 4, smooth_seed=5)
    if mode == "int8":
        kw["kv_dtype"] = "int8"
        ref_kw["kv_smooth"] = port_kw["kv_smooth"] = _smooth(model.cfg)
    ref = ref_engine.ServingEngine(model, params, ref_engine.EngineConfig(**kw), **ref_kw)
    port = port_engine.ServingEngine(port_model(arch, n_layers=2), _port_tree(params),
                                     port_engine.EngineConfig(**kw), device="cpu", **port_kw)
    want, got = _lockstep(ref, port, _prompts(model.cfg.vocab, 5, seed=6), 7)
    assert got == want, (f"{arch}/{mode}: tokens diverge from the reference's; check its "
                         f"top-2 logit margin at the first difference before calling it a fault")
    assert len({tuple(t) for t in want}) > 1 and all(len(t) == 7 for t in want)
    assert port.cache_stats["shared_block_grants"] > 0
    assert port.cache_stats == ref.cache_stats
    assert set(port.traces) == set(ref.traces)
    if mode == "speculative":
        assert port.spec_rounds == ref.spec_rounds > 0
    port.assert_bounded_traces()
    assert port.alloc.num_free + port.alloc.num_cached == kw["num_blocks"]


@pytest.mark.parametrize("mode", ["continuous", "static", "describe"])
def test_serve_cli(mode, caplog):
    """`python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b
    --reduced` in both modes on the CPU (the continuous one LCD-compressed
    first), and `--describe`, which counts the packed bytes of the clustered
    attention and the bytes left dense (the experts among them)."""
    argv = ["--arch", PHI, "--reduced", "--tokens", "4", "--prompt-len", "10",
            "--device", "cpu"]
    flags = {"continuous": ["--continuous", "--requests", "3", "--lcd"],
             "static": ["--batch", "2"],
             "describe": ["--continuous", "--lcd", "--describe"]}[mode]
    with caplog.at_level("INFO", logger="repro_torch"):
        out = port_serve.main(argv + flags)
    if mode == "static":
        assert tuple(out.shape) == (2, 4)
    elif mode == "continuous":
        assert len(out) == 3 and all(len(r.out_tokens) == 4 for r in out)
    else:
        cfg = port_model(PHI).cfg
        experts = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff * 4
        packed = 4 * cfg.n_layers * cfg.d_model * cfg.d_model // 2
        assert f"target packed weight bytes: {packed}" in caplog.text
        dense = int(caplog.text.split("target dense weight bytes: ")[1].split()[0])
        assert dense > experts
