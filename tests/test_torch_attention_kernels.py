"""The port's B8 `paged_dequant_attention` and B9 `flash_attention` on the CPU
(the wrappers run their plain versions there) against the reference.

B8 is held to the reference's Pallas kernel in interpret mode and to its
oracle `repro.kernels.ref.paged_dequant_attention_ref`, at
tests/test_paged_kv.py's shapes, windows and softcaps and at a qwen2-like GQA
group of 6: rtol 2e-5, atol 2e-5 (f32; materialized softmax on both sides,
sums in another order). B9 is held to `repro.kernels.ref.flash_attention_ref`
— not to the Pallas kernel, whose interpreter tests are red on this JAX
build — at tests/test_kernels.py's shapes, masks and dtypes: 2e-5 in f32,
3e-2 in bf16 (the reference's own bf16 tolerance); its `k_len`, which the
reference's oracle lacks, against the oracle on keys cut to `k_len`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as ref_pa
from repro.kernels import ref as ref_ref
from repro_torch.kernels import autotune as port_at
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import paged_attention as port_pa
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels.flash_attention import flash_attention as port_flash

from _xfw import assert_close, assert_equal, np_of

pytestmark = pytest.mark.tier1


@pytest.fixture(autouse=True)
def fresh_cache(tmp_path):
    """Each test tunes against an empty cache file of its own."""
    port_at.reset_cache(str(tmp_path / "autotune.json"))
    yield
    port_at.reset_cache()


# ---------------------------------------------------------------------------
# B8: paged_dequant_attention
# ---------------------------------------------------------------------------

def _dequant_case(s, t, h, kv, d, l, seed):
    """tests/test_paged_kv.py TestKernelVsOracle._mk, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(s, t, h, d)).astype(np.float32)
    kq = rng.integers(-127, 128, (s, l, kv, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (s, l, kv, d)).astype(np.int8)
    ks = (np.abs(rng.normal(0.01, 3e-3, (s, l, kv))) + 1e-4).astype(np.float32)
    vs = (np.abs(rng.normal(0.01, 3e-3, (s, l, kv))) + 1e-4).astype(np.float32)
    ksm = (np.abs(rng.normal(1, .2, (kv, d))) + .5).astype(np.float32)
    vsm = (np.abs(rng.normal(1, .2, (kv, d))) + .5).astype(np.float32)
    lengths = rng.integers(0, l - t, s).astype(np.int32)
    n_new = rng.integers(0, t + 1, s).astype(np.int32)
    return q, kq, ks, vq, vs, ksm, vsm, lengths, n_new


def _port_dequant(args, window, softcap=0.0, **kw):
    return np_of(port_pa.paged_dequant_attention(
        *[torch.from_numpy(a) for a in args], window, softcap=softcap, **kw))


DEQUANT_SHAPES = {
    "gqa2_prefill": (3, 4, 4, 2, 32, 24),      # the reference's three shapes
    "mha_decode_d16": (2, 1, 4, 4, 16, 16),
    "gqa4_chunk": (4, 8, 8, 2, 32, 32),
    "qwen2_gqa6": (3, 4, 12, 2, 32, 40),       # qwen2-1.5b's group: 12 heads over 2
}
DEQUANT_MASKS = {"global": (0, 0.0), "window8": (8, 0.0), "softcap30": (0, 30.0),
                 "window6_softcap20": (6, 20.0)}


@pytest.mark.parametrize("mask", DEQUANT_MASKS)
@pytest.mark.parametrize("shape", DEQUANT_SHAPES)
def test_dequant_vs_reference_oracle(shape, mask):
    window, softcap = DEQUANT_MASKS[mask]
    args = _dequant_case(*DEQUANT_SHAPES[shape], seed=len(shape) + 3 * window)
    want = np.asarray(ref_ref.paged_dequant_attention_ref(
        *[jnp.asarray(a) for a in args], jnp.int32(window), softcap=softcap))
    got = _port_dequant(args, window, softcap)
    assert got.shape == args[0].shape and got.dtype == np.float32
    assert_close(got, want, rtol=2e-5, atol=2e-5, what=f"{shape}/{mask} vs oracle")
    # the wrapper on a CPU tensor IS the plain version
    assert_equal(got, np_of(port_ref.paged_dequant_attention_ref(
        *[torch.from_numpy(a) for a in args], window, softcap=softcap)),
        "wrapper vs plain version")


@pytest.mark.parametrize("mask", ["global", "window6_softcap20"])
@pytest.mark.parametrize("shape", DEQUANT_SHAPES)
def test_dequant_vs_pallas_kernel_in_interpret_mode(shape, mask):
    window, softcap = DEQUANT_MASKS[mask]
    args = _dequant_case(*DEQUANT_SHAPES[shape], seed=11 + len(shape))
    want = np.asarray(ref_pa.paged_dequant_attention(
        *[jnp.asarray(a) for a in args], jnp.int32(window), softcap=softcap,
        interpret=True))
    got = _port_dequant(args, window, softcap)
    assert_close(got, want, rtol=2e-5, atol=2e-5, what=f"{shape}/{mask} vs Pallas")


def test_dequant_window_as_a_0d_tensor_and_an_int_agree():
    args = _dequant_case(*DEQUANT_SHAPES["gqa4_chunk"], seed=4)
    assert_equal(_port_dequant(args, torch.tensor(7, dtype=torch.int32), 15.0),
                 _port_dequant(args, 7, 15.0), "window tensor vs int")


def test_dequant_idle_slot_gives_zeros_and_bf16_queries_run():
    args = list(_dequant_case(*DEQUANT_SHAPES["qwen2_gqa6"], seed=5))
    args[7][1] = args[8][1] = 0                            # slot 1: idle
    got = _port_dequant(args, 0)
    assert np.all(got[1] == 0), "a slot with nothing visible must give zeros"
    t = [torch.from_numpy(a) for a in args]
    out = port_pa.paged_dequant_attention(t[0].bfloat16(), *t[1:], 0)
    assert out.dtype == torch.bfloat16
    assert_close(np_of(out), got, rtol=2 ** -7, atol=2 ** -7, what="bf16 q")


def test_dequant_equals_pool_attention_on_a_gathered_view():
    """B8 on a view gathered through the block tables is B5 on the pool: the
    same definition (the card's kernels give the same bits; here, the plain
    versions agree to f32 rounding)."""
    rng = np.random.default_rng(6)
    s, t, h, kv, d, bs, nbw, nb = 3, 4, 8, 2, 32, 8, 5, 20
    kp = rng.integers(-127, 128, (nb, bs, kv, d)).astype(np.int8)
    vp = rng.integers(-127, 128, (nb, bs, kv, d)).astype(np.int8)
    ksp = (0.005 + rng.random((nb, bs, kv)) * 0.02).astype(np.float32)
    vsp = (0.005 + rng.random((nb, bs, kv)) * 0.02).astype(np.float32)
    ksm = (0.5 + rng.random((kv, d))).astype(np.float32)
    vsm = (0.5 + rng.random((kv, d))).astype(np.float32)
    bt = rng.permutation(nb)[:s * nbw].reshape(s, nbw).astype(np.int32)
    q = rng.standard_normal((s, t, h, d)).astype(np.float32)
    lengths = np.array([30, 3, 17], np.int32)
    n_new = np.array([t, 2, 0], np.int32)
    view = [a[bt].reshape(s, nbw * bs, *a.shape[2:]) for a in (kp, ksp, vp, vsp)]
    got = _port_dequant((q, view[0], view[1], view[2], view[3], ksm, vsm, lengths, n_new), 5)
    pool = np_of(port_pa.paged_pool_attention(
        *[torch.from_numpy(a) for a in (q, kp, vp, bt, lengths, n_new)], 5,
        k_scale=torch.from_numpy(ksp), v_scale=torch.from_numpy(vsp),
        k_smooth=torch.from_numpy(ksm), v_smooth=torch.from_numpy(vsm)))
    assert_close(got, pool, rtol=1e-6, atol=1e-6, what="gathered view vs pool")


def test_dequant_rejects_what_the_kernel_does_not_take():
    t = [torch.from_numpy(a) for a in _dequant_case(*DEQUANT_SHAPES["gqa2_prefill"], seed=1)]
    with pytest.raises(TypeError, match="n_new must be int32"):
        port_pa.paged_dequant_attention(*t[:8], t[8].long(), 0)
    with pytest.raises(ValueError, match="vq must be int8"):
        port_pa.paged_dequant_attention(t[0], t[1], t[2], t[3].float(), *t[4:], 0)
    with pytest.raises(ValueError, match="k_scale must be float32"):
        port_pa.paged_dequant_attention(t[0], t[1], t[2][:, :5].contiguous(), *t[3:], 0)
    with pytest.raises(ValueError, match="KV | H"):
        port_pa.paged_dequant_attention(t[0][:, :, :3].contiguous(), *t[1:], 0)
    with pytest.raises(ValueError, match="0-d int32"):
        port_pa.paged_dequant_attention(*t, torch.tensor([3], dtype=torch.int32))
    # the card's own limits are checked before anything launches
    q, kq, vq = t[0][..., :16].contiguous(), t[1][..., :16], t[3][..., :16]
    with pytest.raises(ValueError, match="multiple of 32 and <= 256"):
        port_pa._check_dequant_card(q, kq, vq, 128)
    with pytest.raises(ValueError, match="one thread block holds at most 232448"):
        port_pa._check_dequant_card(t[0], t[1], t[3], 4096)
    port_pa._check_dequant_card(t[0], t[1], t[3], 256)       # the tuner's candidates run


@pytest.mark.parametrize("l", [24, 128, 129, 512, 4096])
def test_dequant_every_candidate_pad_is_a_stage_the_card_runs(l):
    """On the card l_pad is the stage of the shared block body's staging
    ring (kernels/paged_attention.py pool_plan): a whole number of its 32-key
    chunks. Every pad the tuner proposes is one, and runs at llama2-7b's and
    qwen2-1.5b's shapes."""
    for (l_pad,) in port_at.paged_candidates(l):
        assert l_pad % port_pa.CHUNK == 0
        for t, h, kv in ((1, 32, 32), (32, 32, 32), (32, 12, 2)):
            q = torch.zeros((8, t, h, 128))
            kq = torch.zeros((8, l, kv, 128), dtype=torch.int8)
            plan = port_pa._check_dequant_card(q, kq, kq, l_pad)
            assert plan["stage_keys"] == l_pad
            assert plan["smem_bytes"] <= 232448


def test_dequant_card_refuses_a_pad_that_splits_a_chunk():
    q = torch.zeros((2, 1, 4, 64))
    kq = torch.zeros((2, 96, 2, 64), dtype=torch.int8)
    port_pa._check_dequant_card(q, kq, kq, 96)
    for l_pad in (16, 48, 100):
        with pytest.raises(ValueError, match="whole 32-key chunks"):
            port_pa._check_dequant_card(q, kq, kq, l_pad)


def test_dequant_cpu_route_picks_its_pad_without_measuring():
    port_ops.reset_launch_counts()
    args = _dequant_case(*DEQUANT_SHAPES["gqa4_chunk"], seed=2)
    assert_equal(_port_dequant(args, 0), _port_dequant(args, 0, l_pad=256), "l_pad")
    assert port_at.get_cache().measured == {"flash": 0, "paged": 0}
    assert port_ops.launch_counts()["paged_dequant_attention"] == 0


# ---------------------------------------------------------------------------
# B9: flash_attention
# ---------------------------------------------------------------------------

def _flash_case(bh, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, s, d)).astype(np.float32) for s in (sq, sk, sk)]


def _ref_flash(arrays, dtype=jnp.float32, **kw):
    return np.asarray(ref_ref.flash_attention_ref(
        *[jnp.asarray(a, dtype) for a in arrays], **kw), np.float32)


def _port_flash(arrays, dtype=torch.float32, **kw):
    return np_of(port_flash(*[torch.from_numpy(a).to(dtype) for a in arrays],
                                         **kw))


@pytest.mark.parametrize("bh,sq,sk,d", [(4, 256, 256, 64), (2, 512, 512, 128),
                                        (1, 128, 512, 64), (8, 256, 256, 32)])
def test_flash_causal(bh, sq, sk, d):
    arrays = _flash_case(bh, sq, sk, d, seed=sq + d)
    assert_close(_port_flash(arrays, bq=128, bk=128), _ref_flash(arrays),
                 rtol=2e-5, atol=2e-5, what=f"causal {bh}x{sq}x{sk}x{d}")


@pytest.mark.parametrize("kw", [dict(causal=False), dict(window=64), dict(softcap=50.0),
                                dict(window=128, softcap=30.0), dict(window=40)],
                         ids=["noncausal", "window64", "softcap50", "window128_softcap30",
                              "window40_narrower_than_bk"])
def test_flash_variants(kw):
    arrays = _flash_case(2, 256, 256, 64, seed=11)
    assert_close(_port_flash(arrays, bq=128, bk=128, **kw), _ref_flash(arrays, **kw),
                 rtol=2e-5, atol=2e-5, what=str(kw))


def test_flash_bf16():
    arrays = _flash_case(2, 256, 256, 64, seed=3)
    got = _port_flash(arrays, torch.bfloat16, bq=128, bk=128)
    assert_close(got, _ref_flash(arrays, jnp.bfloat16), rtol=3e-2, atol=3e-2, what="bf16")


@pytest.mark.parametrize("window", [0, 100])
def test_flash_q_offset_decode_window(window):
    arrays = _flash_case(2, 128, 512, 64, seed=7)
    assert_close(_port_flash(arrays, bq=128, bk=128, q_offset=384, window=window),
                 _ref_flash(arrays, q_offset=384, window=window), rtol=2e-5, atol=2e-5,
                 what=f"q_offset 384, window {window}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_k_len_equals_the_oracle_on_cut_keys(causal):
    q, k, v = _flash_case(2, 64, 256, 32, seed=9)
    k_len = 150
    want = _ref_flash([q, k[:, :k_len], v[:, :k_len]], causal=causal, q_offset=k_len - 64)
    got = _port_flash([q, k, v], bq=64, bk=128, causal=causal, q_offset=k_len - 64,
                      k_len=k_len)
    assert_close(got, want, rtol=2e-5, atol=2e-5, what=f"k_len {k_len}")


def test_flash_rows_that_see_no_key_average_every_value_as_the_reference():
    """k_len and a window can leave a row nothing: every score is -1e30 and
    the reference's softmax spreads evenly over all keys."""
    q, k, v = _flash_case(1, 64, 128, 32, seed=12)
    got = _port_flash([q, k, v], bq=64, bk=128, q_offset=64, window=8, k_len=40)
    assert_close(got[0, -1], v[0].mean(0), rtol=1e-5, atol=1e-5, what="no visible key")


def test_flash_the_tile_must_divide_the_problem():
    t = [torch.from_numpy(a) for a in _flash_case(1, 96, 192, 32, seed=0)]
    port_flash(*t, bq=96, bk=192)                 # whole blocks
    port_flash(*t, bq=512, bk=1024)               # clamped to (96, 192)
    with pytest.raises(ValueError, match="Sq 96 % bq 64"):
        port_flash(*t, bq=64, bk=64)
    with pytest.raises(ValueError, match="Sk 192 % bk 128"):
        port_flash(*t, bq=32, bk=128)
    with pytest.raises(TypeError, match="must all be float32 or all bfloat16"):
        port_flash(t[0], t[1].bfloat16(), t[2], bq=32, bk=64)
    with pytest.raises(ValueError, match="must be contiguous"):
        port_flash(t[0].transpose(1, 2).contiguous().transpose(1, 2), *t[1:],
                                bq=32, bk=64)


def test_flash_cpu_route_takes_the_cached_tile_or_the_heuristic_never_measures():
    arrays = _flash_case(1, 256, 256, 32, seed=1)
    want = _ref_flash(arrays)
    assert_close(_port_flash(arrays), want, rtol=2e-5, atol=2e-5, what="heuristic tile")
    # a cached tile for the CPU is used: this one does not divide Sq, so the
    # call refuses it with the reference's rule
    port_at.get_cache().put(port_at.normalize_key(256, 256, 32, 0, "flash", "cpu"),
                            (96, 128), 1.0)
    with pytest.raises(ValueError, match="Sq 256 % bq 96"):
        _port_flash(arrays)
    assert port_at.get_cache().measured == {"flash": 0, "paged": 0}
    assert port_ops.launch_counts()["flash_attention"] == 0


# the card's tile rules (kernels/flash_attention.py card_tile), checked on the
# CPU: every tile the tuner proposes at the prefill geometry runs at every D the
# kernels take, in both dtypes
PREFILL_TILES = port_at.flash_candidates(4096, 4096)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("bq,bk", PREFILL_TILES, ids=[f"{a}x{b}" for a, b in PREFILL_TILES])
def test_flash_card_admits_every_candidate_tile(bq, bk, d, dtype):
    from repro_torch.kernels.flash_attention import card_tile
    got = card_tile(d, bq, bk, dtype)
    assert got["smem_bytes"] <= 232448
    if dtype == torch.bfloat16:
        # tensor cores: D padded to 16, the softmax in the kernel's own key chunks
        assert got["kernel"] == "tensor_cores"
        assert got["d_pad"] % 16 == 0 and d <= got["d_pad"] < d + 16
        assert got["rows_per_pass"] == 128 and got["key_step"] == 32
    else:
        assert got["kernel"] == "cuda_cores" and got["key_step"] == bk
        assert got["rows_per_pass"] == min(bq, 64, 8192 // bk)


def test_flash_card_tile_rules():
    from repro_torch.kernels.flash_attention import card_tile
    for dtype in (torch.bfloat16, torch.float32):
        # the heuristic and the smallest tile are what the tuner returns unmeasured
        assert (256, 512) in PREFILL_TILES and (64, 128) in PREFILL_TILES
        card_tile(128, 256, 512, dtype)
        card_tile(128, 64, 128, dtype)
        card_tile(1, 1, 1, dtype)
        with pytest.raises(ValueError, match="D <= 256; got D 272"):
            card_tile(272, 64, 128, dtype)
        with pytest.raises(ValueError, match="bq and bk must be >= 1"):
            card_tile(64, 0, 128, dtype)
    # only the f32 kernel keeps bk as its step in a shared score tile
    assert card_tile(64, 64, 16384, torch.bfloat16)["key_step"] == 32
    with pytest.raises(ValueError, match="bk <= 8192 keys; got bk 16384"):
        card_tile(64, 64, 16384, torch.float32)
    with pytest.raises(TypeError, match="no kernel for torch.float16"):
        card_tile(64, 64, 128, torch.float16)
    # the bf16 kernel's shared memory: a 128-row Q tile and three stages of 32
    # keys of K and V, rows padded by 8 elements
    assert card_tile(128, 64, 128, torch.bfloat16)["smem_bytes"] == 2 * (128 + 192) * 136
    assert card_tile(256, 64, 128, torch.bfloat16)["smem_bytes"] == 2 * (128 + 192) * 264

