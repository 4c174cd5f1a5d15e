"""The GEMV plan (kernels/lut_matmul.py gemv_plan, the host mirror of
csrc/lut_gemv.cuh make_plan, which the B1 / B3 / B6 / B7 launchers run below
128 rows): the units of a launch cover every output element of every
projection exactly once, no strip straddles two projections, a block's shared
memory fits the card, the single-instance path is taken exactly when every
projection has the same width and quantize flag, and what the launchers
refuse raises ValueError. The card holds the mirror to the C plan in
chip_smoke.py's build phase."""
import pytest

from repro_torch.kernels.lut_matmul import MAX_PROJ, gemv_plan

pytestmark = pytest.mark.tier1

# (K, output widths): llama2-7b's and qwen2-1.5b's fused groups, the solo
# projections, ragged shapes
SHAPES = {
    "llama2-7b qkv": (4096, (4096, 4096, 4096)),
    "llama2-7b gate_up": (4096, (11008, 11008)),
    "qwen2-1.5b qkv": (1536, (2048, 256, 256)),
    "qwen2-1.5b gate_up": (1536, (8960, 8960)),
    "llama2-7b wo": (4096, (4096,)),
    "llama2-7b down": (11008, (4096,)),
    "ragged": (132, (37,)),
    "ragged group": (136, (37, 16, 8)),
    "n 4100": (4096, (4100, 4096, 64)),
}
CARD_SMEM = 232448


def _unit(plan, u):
    """Unit u of a plan as the block body walks it (csrc/lut_gemv.cuh):
    strip u // row_blocks, row block u % row_blocks; the strip's projection
    is the last with strip0[p] <= strip. Returns the projection, its columns
    and the rows written, half-open."""
    t, mb = divmod(u, plan["row_blocks"])
    p = max(q for q, s in enumerate(plan["strip0"][:-1]) if s <= t)
    c0 = (t - plan["strip0"][p]) * plan["cols_per_strip"]
    r0 = mb * plan["rows_per_block"]
    return (p, (c0, min(c0 + plan["cols_per_strip"], plan["widths"][p])),
            (r0, min(r0 + plan["rows_per_block"], plan["m"])))


def _configs(p):
    # a single projection's second configuration is 2-bit unquantized
    return {"uniform": ((4,) * p, (True,) * p),
            "mixed": ((4, 2, 4)[:p], (True, False, True)[:p]) if p > 1 else ((2,), (False,))}


@pytest.mark.parametrize("m", [1, 4, 5, 8, 9, 127])
@pytest.mark.parametrize("config", ["uniform", "mixed"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_units_cover_every_output_once(shape, config, m):
    k, widths = SHAPES[shape]
    nbits, quantize = _configs(len(widths))[config]
    plan = gemv_plan(m, k, widths, nbits, quantize, x_bytes=2, sms=132)
    seen = [[0] * w for w in widths]
    rows = {}
    for u in range(plan["units"]):
        p, (c0, c1), (r0, r1) = _unit(plan, u)
        # a strip is one projection's columns: it never runs past its width
        assert 0 <= c0 < c1 <= widths[p] and c1 - c0 <= plan["cols_per_strip"] == 32
        assert 0 <= r0 < r1 <= m and r1 - r0 <= plan["rows_per_block"]
        for c in range(c0, c1):
            seen[p][c] += 1
        rows.setdefault((p, c0), []).append((r0, r1))
    assert all(v == plan["row_blocks"] for s in seen for v in s)
    for spans in rows.values():                  # the row blocks of a strip tile 0..m
        assert sorted(spans)[0][0] == 0 and sorted(spans)[-1][1] == m
        assert all(a[1] == b[0] for a, b in zip(sorted(spans), sorted(spans)[1:]))
    assert plan["units"] == plan["strips"] * plan["row_blocks"]
    # every activation type fits the card, f32 with a shorter ring
    for x_bytes, ring in ((4, 3), (2, 4), (1, 4)):
        other = gemv_plan(m, k, widths, nbits, quantize, x_bytes=x_bytes, sms=132)
        assert other["smem_bytes"] <= CARD_SMEM and other["ring_stages"] == ring
        assert {key: other[key] for key in ("units", "grid", "rows_per_block")} == {
            key: plan[key] for key in ("units", "grid", "rows_per_block")}
    kblocks = -(-k // 8)
    assert plan["stages_per_unit"] == -(-kblocks // 64)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_grid_and_rows_per_block(shape):
    k, widths = SHAPES[shape]
    p = len(widths)
    for m in range(1, 128):
        uni = gemv_plan(m, k, widths, (4,) * p, (True,) * p, sms=132)
        assert uni["uniform"] and uni["rows_per_block"] == (4 if m <= 4 else 8)
        assert uni["grid"] == min(uni["units"], 132)            # persistent
        mixed = gemv_plan(m, k, widths, (4,) * p, (True, False, True)[:p] if p > 1 else
                          (True,), sms=132)
        if p > 1:
            assert not mixed["uniform"] and mixed["rows_per_block"] == 8
            assert mixed["grid"] == mixed["units"]              # one block a unit


@pytest.mark.parametrize("nbits,quantize,uniform", [
    ((4, 4, 4), (True, True, True), True),
    ((2, 2), (False, False), True),
    ((3,), (True,), True),
    ((4, 4, 2), (True, True, True), False),
    ((4, 4, 4), (True, False, True), False),
    ((3, 4), (False, False), False),
])
def test_uniform_exactly_when_widths_and_transforms_agree(nbits, quantize, uniform):
    widths = (64,) * len(nbits)
    for m in (1, 4, 8, 100):
        assert gemv_plan(m, 4096, widths, nbits, quantize)["uniform"] is uniform


@pytest.mark.parametrize("m,k,widths,nbits,quantize,x_bytes", [
    (0, 4096, (64,), (4,), (True,), 2),
    (128, 4096, (64,), (4,), (True,), 2),
    (8, 0, (64,), (4,), (True,), 2),
    (8, 4096, (0,), (4,), (True,), 2),
    (8, 4096, (64, -1), (4, 4), (True, True), 2),
    (8, 4096, (64,), (5,), (True,), 2),
    (8, 4096, (64,), (1,), (True,), 2),
    (8, 4095, (64,), (4,), (True,), 2),          # K * nbits not a whole byte
    (8, 4100, (64,), (3,), (True,), 2),
    (8, 4096, (), (), (), 2),
    (8, 4096, (64,) * (MAX_PROJ + 1), (4,) * (MAX_PROJ + 1), (True,) * (MAX_PROJ + 1), 2),
    (8, 4096, (64, 64), (4,), (True, True), 2),
    (8, 4096, (64,), (4,), (True,), 3),          # activations of 3 bytes
])
def test_refuses_what_the_launchers_refuse(m, k, widths, nbits, quantize, x_bytes):
    with pytest.raises(ValueError):
        gemv_plan(m, k, widths, nbits, quantize, x_bytes=x_bytes)


def test_shared_memory_by_width_and_rows():
    # the 3-bit body keeps 8 codebook entries, not a byte table
    assert (gemv_plan(8, 4096, (64,), (3,), (True,))["smem_bytes"]
            < gemv_plan(8, 4096, (64,), (2,), (True,))["smem_bytes"]
            < gemv_plan(8, 4096, (64,), (4,), (True,))["smem_bytes"] <= CARD_SMEM)
    assert (gemv_plan(4, 4096, (64,), (4,), (True,))["smem_bytes"]
            < gemv_plan(5, 4096, (64,), (4,), (True,))["smem_bytes"])
    # a mixed group is sized for its largest body
    assert (gemv_plan(8, 4096, (64, 64), (2, 4), (True, True))["smem_bytes"]
            == gemv_plan(8, 4096, (64,), (4,), (True,))["smem_bytes"])
