"""The port's clustering primitives (`repro_torch.core.clustering`, on the CPU)
against the reference's (`repro.core.clustering`), the same numpy inputs
through both.

Tolerances: the numpy parts (DBCI with its subsample, k-means, the grid,
make_state) are exact; so are codes (`assign`, including its tie rule) and
active masks. f32 state values (centroids, counts, the objective) are held to
rtol 1e-5 — sums of many f32 terms that may be taken in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as RC
from repro_torch.core import clustering as PC

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import assert_close, assert_equal, np_of

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]


def _weights(seed, shape=(96, 80), outliers=True):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.02, shape).astype(np.float32)
    if outliers:
        w.reshape(-1)[rng.choice(w.size, 12, replace=False)] *= 8
    return w


def _port_state(rs):
    return PC.ClusterState(*(torch.from_numpy(np.array(a)) for a in rs))


def _same_state(ps, rs, what):
    assert_equal(np_of(ps.active), np.asarray(rs.active), f"{what}: active")
    act = np.asarray(rs.active)
    assert_close(np_of(ps.centroids)[act], np.asarray(rs.centroids)[act], rtol=1e-5,
                 what=f"{what}: centroids")
    assert np.all(np.isinf(np_of(ps.centroids)[~act]))
    assert_close(np_of(ps.counts), np.asarray(rs.counts), rtol=1e-5, atol=1e-30,
                 what=f"{what}: counts")


# ---------------------------------------------------------------------------
# DBCI, k-means, the grid: numpy, exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((96, 80), 0), ((64, 64), 1), ((400, 400), 2),
                                        ((40,), 3)], ids=["small", "square", "subsampled",
                                                          "tiny"])
@pytest.mark.parametrize("eps_scale", [1.0, 2.0, 1.5])
def test_dbci_is_exact(shape, seed, eps_scale):
    """(400, 400) = 160 000 weights > 2^17: the subsample path, by the
    reference's own generator. A tensor gives the numpy array's result (the
    port picks the same indices and copies only them)."""
    w = _weights(seed, shape)
    want = RC.dbci_init(w, eps_scale=eps_scale, seed=seed)
    for arg in (w, torch.from_numpy(w)):
        got = PC.dbci_init(arg, eps_scale=eps_scale, seed=seed)
        assert_equal(got.centroids, want.centroids, "DBCI centroids")
        assert got.centroids.dtype == np.float32
        assert (got.eps, got.min_pts, got.sigma, got.n_noise) == (
            want.eps, want.min_pts, want.sigma, want.n_noise)


def test_dbci_drops_non_finite_weights_and_refuses_an_empty_tensor():
    w = _weights(4)
    w[3, :5] = np.nan
    w[7, 2] = np.inf
    want = RC.dbci_init(w)
    assert_equal(PC.dbci_init(torch.from_numpy(w)).centroids, want.centroids, "DBCI")
    with pytest.raises(ValueError, match="empty"):
        PC.dbci_init(np.full((4, 4), np.nan, np.float32))


def test_estimate_sigma_and_dbscan_are_exact():
    ws = np.sort(_weights(5).reshape(-1).astype(np.float64))
    assert PC.estimate_sigma(ws) == RC.estimate_sigma(ws)
    for eps, min_pts in ((1e-3, 4), (2e-4, 12), (5e-5, 2)):
        got, k = PC._dbscan_1d_sorted(ws, eps, min_pts)
        want, kw = RC._dbscan_1d_sorted(ws, eps, min_pts)
        assert k == kw
        assert_equal(got, want, "DBSCAN labels")


@pytest.mark.parametrize("k", [4, 12])
@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_1d_is_exact_and_the_tensor_path_agrees(k, weighted):
    w = _weights(6)
    hw = np.random.default_rng(7).uniform(0.5, 2.0, w.shape) if weighted else None
    want = RC.kmeans_1d(w, k, weights=hw)
    assert_equal(PC.kmeans_1d(w, k, weights=hw), want, "k-means centroids (numpy)")
    # on a tensor: the same iterations in float64, bin sums in another order
    got = PC.kmeans_1d(torch.from_numpy(w), k,
                       weights=None if hw is None else torch.from_numpy(hw))
    assert_equal(got, want, "k-means centroids (tensor path)")


def test_uniform_grid_and_make_state_are_exact():
    w = _weights(8)
    want = RC.uniform_grid_centroids(w, 4)
    assert_equal(PC.uniform_grid_centroids(w, 4), want, "grid")
    assert_equal(PC.uniform_grid_centroids(torch.from_numpy(w), 4), want, "grid (tensor)")
    for cents in (want, np.linspace(-1, 1, 40).astype(np.float32), want[::-1].copy()):
        ps, rs = PC.make_state(cents, device="cpu"), RC.make_state(cents)
        for a, b in zip(ps, rs):
            assert_equal(np_of(a), np.asarray(b), "make_state")
        assert PC.num_active(ps) == RC.num_active(rs)
        assert_equal(PC.active_centroids(ps), RC.active_centroids(rs), "active centroids")


# ---------------------------------------------------------------------------
# the state operations: torch on the weight's device
# ---------------------------------------------------------------------------

def test_assign_keeps_argmins_first_index_on_exact_ties():
    """Weights exactly halfway between two centroids (|w - c_i| == |w - c_i+1|
    in f32) go to the lower slot, as the reference's argmin sends them; a
    midpoint-boundary search would not reproduce every such case."""
    cents = np.array([-0.5, -0.25, 0.0, 0.125, 0.375], np.float32)
    mids = (cents[1:] + cents[:-1]) / 2
    rng = np.random.default_rng(9)
    w = np.concatenate([mids, rng.normal(0, 0.3, 200).astype(np.float32),
                        cents, [-5.0, 5.0]]).astype(np.float32).reshape(-1, 1)
    rs = RC.make_state(cents)
    want = np.asarray(RC.assign(jnp.asarray(w), rs))
    got = np_of(PC.assign(torch.from_numpy(w), PC.make_state(cents, device="cpu")))
    assert got.dtype == np.int32 and got.shape == w.shape
    assert_equal(got, want, "codes")
    assert_equal(got[:4, 0], np.arange(4), "ties go to the first index")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_dequant_objective_refresh(seed, monkeypatch):
    w = _weights(seed)
    h = np.random.default_rng(seed + 10).uniform(0.2, 3.0, w.shape).astype(np.float32)
    cents = RC.dbci_init(w).centroids
    rs = RC.make_state(cents)
    ps = PC.make_state(cents, device="cpu")
    tw, th = torch.from_numpy(w), torch.from_numpy(h)
    # small chunks: the row-chunked assignment must not change a code
    monkeypatch.setattr(PC, "_CHUNK_BYTES", 4 * 32 * 97)
    rc = RC.assign(jnp.asarray(w), rs)
    pc = PC.assign(tw, ps)
    assert_equal(np_of(pc), np.asarray(rc), "codes")
    assert_equal(np_of(PC.dequant(pc, ps)), np.asarray(RC.dequant(rc, rs)), "dequant")
    assert_close(float(PC.objective(tw, pc, ps, th)),
                 float(RC.objective(jnp.asarray(w), rc, rs, jnp.asarray(h))),
                 rtol=1e-5, what="objective")
    _same_state(PC.refresh(tw, pc, ps, th),
                RC.refresh(jnp.asarray(w), rc, rs, jnp.asarray(h)), "refresh")


def test_the_cards_ordered_cluster_sums_agree_and_repeat(monkeypatch):
    """The refresh sums the card takes (masked sums in a fixed order, chunk
    by chunk) against the CPU's sequential scatter-add, on the CPU: equal to
    rtol 1e-5, and bit-identical from one run to the next."""
    rng = np.random.default_rng(11)
    n = 10_007
    codes = torch.from_numpy(rng.integers(0, 20, n).astype(np.int32))
    vals = torch.from_numpy(rng.uniform(0.1, 2.0, (2, n)).astype(np.float32))
    slots = torch.arange(20, dtype=torch.int32)
    want = PC._sums_sequential(codes, vals)
    monkeypatch.setattr(PC, "_CHUNK_BYTES", 4 * 20 * 1000)
    a = PC._sums_masked(codes, vals, slots)
    b = PC._sums_masked(codes, vals, slots)
    for x, y, z in zip(a, b, want):
        assert torch.equal(x, y)
        assert_close(np_of(x), np_of(z), rtol=1e-5, what="masked vs sequential sums")


@pytest.mark.parametrize("rule", ["salience", "closest"])
def test_merge_closest_both_rules(rule):
    w = _weights(12)
    h = np.ones_like(w)
    rs = RC.make_state(RC.dbci_init(w).centroids)
    rs = RC.refresh(jnp.asarray(w), RC.assign(jnp.asarray(w), rs), rs, jnp.asarray(h))
    ps = _port_state(rs)
    for step in range(6):                       # merge down six times in lockstep
        rs = RC.merge_closest(rs, rule)
        ps = PC.merge_closest(ps, rule)
        _same_state(ps, rs, f"{rule} merge {step}")
        assert_equal(np_of(ps.centroids)[np.asarray(rs.active)],
                     np.asarray(rs.centroids)[np.asarray(rs.active)],
                     f"{rule} merge {step}: centroids (the merged one by a fused multiply-add)")
    # a fresh state (zero counts): the plain midpoint
    fresh = RC.make_state(np.array([0.0, 1.0, 3.0], np.float32))
    got = PC.merge_closest(_port_state(fresh), rule)
    _same_state(got, RC.merge_closest(fresh, rule), f"{rule} fresh")
