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
