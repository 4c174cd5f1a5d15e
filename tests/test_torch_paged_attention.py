"""The port's pool-direct paged attention (plain version, on the CPU) against
the reference oracle `repro.kernels.ref.paged_pool_attention_ref` and against
the Pallas kernel in interpret mode: float and int8 pools, GQA, window,
softcap, ragged lengths, an idle slot, a chunk with n_new < T.

Tolerance rtol 1e-5, atol 1e-5 (f32; materialized vs online softmax), scaled
by the output magnitude for dequantized int8 pools."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as ref_pa
from repro.kernels import ref as ref_ref
from repro.models import layers as ref_layers
from repro_torch.kernels import paged_attention as port_pa
from repro_torch.kernels import ref as port_ref
from repro_torch.models import layers as port_layers

from _xfw import assert_close, assert_equal, np_of

pytestmark = pytest.mark.tier1


def _case(S, T, H, KV, D, bs, nb, int8, seed, idle=True, short_chunk=True):
    rng = np.random.default_rng(seed)
    max_blocks = 6
    lengths = rng.integers(0, bs * max_blocks - T, size=S).astype(np.int32)
    n_new = np.full(S, T, np.int32)
    if short_chunk and T > 1:
        n_new[0] = T // 2                      # a chunk with n_new < T
    if idle:
        lengths[-1], n_new[-1] = 0, 0          # an idle slot
    bt = rng.permutation(nb)[:S * max_blocks].reshape(S, max_blocks).astype(np.int32)
    q = rng.standard_normal((S, T, H, D)).astype(np.float32)
    kw = {}
    if int8:
        kp = rng.integers(-127, 128, (nb, bs, KV, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (nb, bs, KV, D)).astype(np.int8)
        kw.update(
            k_scale=(0.01 + rng.random((nb, bs, KV)) * 0.02).astype(np.float32),
            v_scale=(0.01 + rng.random((nb, bs, KV)) * 0.02).astype(np.float32),
            k_smooth=(0.5 + rng.random((KV, D))).astype(np.float32),
            v_smooth=(0.5 + rng.random((KV, D))).astype(np.float32))
    else:
        kp = rng.standard_normal((nb, bs, KV, D)).astype(np.float32)
        vp = rng.standard_normal((nb, bs, KV, D)).astype(np.float32)
    return (q, kp, vp, bt, lengths, n_new), kw


def _port(args, kw, window, softcap, fn=port_pa.paged_pool_attention):
    t = [torch.from_numpy(a) for a in args]
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    return np_of(fn(*t, window, softcap=softcap, **tkw))


CASES = {
    "float_decode": dict(S=3, T=1, H=8, KV=8, D=64, bs=16, nb=24, int8=False),
    "float_gqa": dict(S=3, T=1, H=8, KV=2, D=64, bs=16, nb=24, int8=False),
    "float_chunk": dict(S=3, T=8, H=4, KV=4, D=32, bs=16, nb=24, int8=False),
    "float_gqa_chunk": dict(S=2, T=8, H=8, KV=2, D=32, bs=8, nb=16, int8=False),
    "int8_decode": dict(S=3, T=1, H=8, KV=8, D=64, bs=16, nb=24, int8=True),
    "int8_gqa_chunk": dict(S=3, T=8, H=8, KV=2, D=32, bs=16, nb=24, int8=True),
}
MASKS = {"global": (0, 0.0), "window": (20, 0.0), "softcap": (0, 15.0),
         "window_softcap": (7, 30.0)}


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("case", CASES)
def test_vs_reference_oracle(case, mask):
    window, softcap = MASKS[mask]
    args, kw = _case(seed=len(case) + 7 * len(mask), **CASES[case])
    want = np.asarray(ref_ref.paged_pool_attention_ref(
        *args, jnp.int32(window), softcap=softcap, **kw))
    got = _port(args, kw, window, softcap)
    assert got.shape == args[0].shape
    scale = max(float(np.abs(want).max()), 1.0)
    assert_close(got, want, rtol=1e-5, atol=1e-5 * scale, what=f"{case}/{mask} vs oracle")
    assert np.all(got[-1] == 0), "an idle slot (length 0, n_new 0) must give zeros"
    # the wrapper on a CPU tensor IS the plain version
    assert_equal(got, _port(args, kw, window, softcap, fn=port_ref.paged_pool_attention_ref),
                 "wrapper vs plain version")


@pytest.mark.parametrize("mask", ["global", "window_softcap"])
@pytest.mark.parametrize("case", CASES)
def test_vs_pallas_kernel_in_interpret_mode(case, mask):
    window, softcap = MASKS[mask]
    args, kw = _case(seed=3 + len(case), **CASES[case])
    want = np.asarray(ref_pa.paged_pool_attention(
        *args, jnp.int32(window), softcap=softcap, interpret=True, **kw))
    got = _port(args, kw, window, softcap)
    scale = max(float(np.abs(want).max()), 1.0)
    assert_close(got, want, rtol=1e-5, atol=2e-5 * scale, what=f"{case}/{mask} vs Pallas")


def test_block_ids_clamp_and_unallocated_entries_are_masked():
    """Table entries past a slot's live blocks may hold anything (the engine
    leaves 0 there; the reference clamps out-of-range ids): the result must not
    depend on them."""
    args, kw = _case(seed=5, idle=False, **CASES["float_chunk"])
    q, kp, vp, bt, lengths, n_new = args
    base = _port(args, kw, 0, 0.0)
    live = -(-(lengths + n_new) // 16)
    bt2 = bt.copy()
    for s in range(bt.shape[0]):
        bt2[s, max(live[s], 1):] = [0, 999, -5][s % 3]
    assert_equal(_port((q, kp, vp, bt2, lengths, n_new), kw, 0, 0.0), base,
                 "dead table entries")


def test_quantize_kv_codes_exact_scales_close():
    rng = np.random.default_rng(2)
    t = (rng.standard_normal((3, 5, 2, 32)) * rng.uniform(0.1, 8, (1, 1, 2, 32))).astype(np.float32)
    smooth = rng.uniform(0.5, 4.0, (2, 32)).astype(np.float32)
    rc, rs = ref_layers.quantize_kv(jnp.asarray(t), jnp.asarray(smooth))
    pc, ps = port_layers.quantize_kv(torch.from_numpy(t), torch.from_numpy(smooth))
    assert pc.dtype == torch.int8 and ps.dtype == torch.float32
    assert_equal(np_of(pc), np.asarray(rc), "int8 KV codes")
    assert_close(np_of(ps), np.asarray(rs), rtol=1e-6, atol=1e-6, what="KV scales")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args, kw = _case(seed=1, **CASES["int8_decode"])
    t = [torch.from_numpy(a) for a in args]
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with pytest.raises(ValueError, match="int8 pools need k_scale"):
        port_pa.paged_pool_attention(*t, 0)
    with pytest.raises(TypeError, match="lengths must be int32"):
        port_pa.paged_pool_attention(t[0], t[1], t[2], t[3], t[4].long(), t[5], 0, **tkw)
    with pytest.raises(ValueError, match="must be contiguous"):
        port_pa.paged_pool_attention(torch.cat([t[0], t[0]], dim=-1)[..., :t[0].shape[-1]],
                                     *t[1:], 0, **tkw)
    with pytest.raises(ValueError, match="multiple of 32"):
        port_pa.paged_pool_attention(t[0][..., :16].contiguous(), t[1][..., :16].contiguous(),
                                     t[2][..., :16].contiguous(), *t[3:], 0,
                                     **{**tkw, "k_smooth": tkw["k_smooth"][:, :16].contiguous(),
                                        "v_smooth": tkw["v_smooth"][:, :16].contiguous()})
    with pytest.raises(ValueError, match="KV | H"):
        port_pa.paged_pool_attention(t[0][:, :, :3].contiguous(), *t[1:], 0, **tkw)


# ---------------------------------------------------------------------------
# the card's rules for the block body (kernels/paged_attention.py pool_plan,
# the same arithmetic as csrc/paged_attention.cuh make_plan), on the CPU
# ---------------------------------------------------------------------------

PLAN_SHAPES = {                       # (T, H, KV): the engine's steps and the tests'
    "llama_decode": (1, 32, 32), "llama_prefill": (32, 32, 32),
    "qwen_decode": (1, 12, 2), "qwen_prefill": (32, 12, 2), "qwen_padded": (32, 16, 2),
    "gqa_chunk": (8, 8, 2), "mha_chunk3": (3, 4, 4),
}


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8],
                         ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_pool_plan_admits_every_shape_the_card_takes(shape, d, pool):
    t, h, kv = PLAN_SHAPES[shape]
    plan = port_pa.pool_plan(t, h, kv, d, pool, s_slots=8)
    g = h // kv
    assert plan["chunk"] == port_pa.CHUNK == 32
    assert plan["smem_bytes"] <= 232448
    assert plan["stage_keys"] % 32 == 0
    assert plan["rows"] == min(32, g * t)
    s_slots, kvs, tiles = plan["grid"]
    assert (s_slots, kvs) == (8, kv) and (tiles - 1) * plan["rows"] < g * t <= tiles * plan["rows"]
    # every row in one group of one warp; a row's chunks split only at <= 4 rows
    assert plan["rows_per_warp"] * plan["groups"] >= plan["rows"]
    assert plan["groups"] * plan["warps_per_row"] <= 8
    assert (plan["warps_per_row"] > 1) == (plan["rows"] <= 4)
    if plan["warps_per_row"] > 1:
        assert plan["rows_per_warp"] == 1
    assert plan["row_bytes"] == d * torch.empty((), dtype=pool).element_size() + 16


def test_pool_plan_rules():
    bf16 = torch.bfloat16
    # llama2-7b decode: one row, 8 warps on its chunks, 96-key stages in a ring of 2;
    # q tile + p scratch + partials (2 x 1 x 3 x (128 + 4) floats) + the ring
    plan = port_pa.pool_plan(1, 32, 32, 128, bf16, s_slots=8)
    assert (plan["rows"], plan["warps_per_row"], plan["stage_keys"]) == (1, 8, 96)
    assert plan["smem_bytes"] == 4 * (128 + 8 * 4 * 32 + 2 * 3 * 132) + 2 * 2 * 96 * 272
    # llama2-7b prefill width: 32 rows, 4 a warp, no partials, 64-key stages
    plan = port_pa.pool_plan(32, 32, 32, 128, bf16)
    assert (plan["rows"], plan["rows_per_warp"], plan["warps_per_row"]) == (32, 4, 1)
    assert plan["smem_bytes"] == 4 * (32 * 128 + 8 * 4 * 32) + 2 * 2 * 64 * 272
    # 9 to 16 rows: 2 a warp
    assert port_pa.pool_plan(16, 8, 8, 128, bf16)["rows_per_warp"] == 2
    # int8 adds the K smoothing and each stage's scales
    plan = port_pa.pool_plan(32, 32, 32, 128, torch.int8)
    assert plan["smem_bytes"] == 4 * (32 * 128 + 8 * 4 * 32 + 128) + 2 * (2 * 64 * 144 + 2 * 64 * 4)
    # where 64-key stages do not fit, 32
    assert port_pa.pool_plan(32, 32, 32, 256, bf16)["stage_keys"] == 64
    assert port_pa.pool_plan(32, 32, 32, 256, torch.float32)["stage_keys"] == 32
    assert port_pa.pool_plan(1, 32, 32, 256, torch.float32)["stage_keys"] == 32
    # what the card refuses, before any launch
    for d in (16, 48, 272):
        with pytest.raises(ValueError, match="multiple of 32 and <= 256"):
            port_pa.pool_plan(1, 8, 8, d, bf16)
    with pytest.raises(ValueError, match="whole 32-key chunks; got 48"):
        port_pa.pool_plan(1, 8, 8, 64, bf16, stage_keys=48)
    with pytest.raises(ValueError, match="one thread block holds at most 232448"):
        port_pa.pool_plan(1, 32, 32, 256, torch.float32, stage_keys=256)
    with pytest.raises(ValueError, match="KV | H"):
        port_pa.pool_plan(1, 12, 5, 128, bf16)


# ---------------------------------------------------------------------------
# the canonical per-row key order (csrc/paged_attention.cuh), emulated in
# numpy float32: 32-key chunks, each a fresh softmax, folded left in key order
# ---------------------------------------------------------------------------

def _canonical_row(q, k, v, lo, hi, scale, softcap=0.0, skip=True):
    f = np.float32
    m, l, acc = f(-1e30), f(0), np.zeros(q.shape[-1], np.float32)
    for c0 in range(0, k.shape[0], 32):
        if skip and not max(lo, c0) < min(hi, c0 + 32):
            continue
        kc, vc = k[c0:c0 + 32], v[c0:c0 + 32]
        d = q.shape[-1]
        parts = [np.zeros(len(kc), np.float32) for _ in range(8)]
        for i in range(0, d, 8):
            for u in range(8):
                parts[u] = parts[u] + q[i + u] * kc[:, i + u]
        sc = ((parts[0] + parts[1]) + (parts[2] + parts[3])) + \
            ((parts[4] + parts[5]) + (parts[6] + parts[7]))
        sc = sc * f(scale)
        if softcap > 0:
            sc = f(softcap) * np.tanh(sc / f(softcap))
        cols = np.arange(c0, c0 + len(kc))
        vis = (cols >= lo) & (cols < hi)
        mc = np.where(vis, sc, f(-1e30)).max().astype(np.float32)
        p = np.where(vis, np.exp(np.where(vis, sc - mc, f(0))), f(0)).astype(np.float32)
        lc, pv = p.sum(dtype=np.float32), np.zeros_like(acc)
        for j in range(len(kc)):
            pv = pv + p[j] * vc[j]
        mm = max(m, mc)
        a, b = np.exp(f(m - mm)), np.exp(f(mc - mm))
        l, acc, m = lc * b + l * a, pv * b + acc * a, mm
    return acc / max(l, f(1e-30))


@pytest.mark.parametrize("case", ["float_decode", "float_gqa_chunk", "int8_gqa_chunk"])
@pytest.mark.parametrize("mask", ["global", "window_softcap"])
def test_canonical_order_is_the_oracle_and_its_skip_moves_no_bit(case, mask):
    window, softcap = MASKS[mask]
    args, kw = _case(seed=11 + len(case), **CASES[case])
    q, kp, vp, bt, lengths, n_new = args
    want = np.asarray(ref_ref.paged_pool_attention_ref(
        *args, jnp.int32(window), softcap=softcap, **kw))
    s_slots, t, h, d = q.shape
    nb, bs, kv, _ = kp.shape
    g = h // kv
    def view(pool):
        return pool[np.clip(bt, 0, nb - 1)].reshape(s_slots, -1, *pool.shape[2:])

    k, v = view(kp).astype(np.float32), view(vp).astype(np.float32)
    if kp.dtype == np.int8:
        k = (k * view(kw["k_scale"])[..., None]) * kw["k_smooth"]
        v = (v * view(kw["v_scale"])[..., None]) * kw["v_smooth"]
    got = np.zeros_like(want)
    for s in range(s_slots):
        for tt in range(t):
            pos = lengths[s] + tt
            lo = max(0, pos - window + 1) if window > 0 else 0
            hi = min(pos + 1, lengths[s] + n_new[s], k.shape[1])
            for hh in range(h):
                row = [q[s, tt, hh], k[s, :, hh // g], v[s, :, hh // g], lo, hi,
                       1 / np.sqrt(np.float32(d)), softcap]
                got[s, tt, hh] = _canonical_row(*row)
                if (s + tt + hh) % 5 == 0:   # every chunk taken: the same bits
                    assert_equal(_canonical_row(*row, skip=False), got[s, tt, hh],
                                 f"skip, row {(s, tt, hh)}")
    scale = max(float(np.abs(want).max()), 1.0)
    assert_close(got, want, rtol=1e-5, atol=1e-5 * scale, what=f"{case}/{mask} canonical order")
