"""The port's packing contract against the reference's, byte for byte:
pack_codes / unpack_codes / padded_d_in / packed_rows at nbits 2, 3, 4 with odd
d_in and stacked leading axes."""
import numpy as np
import pytest
import torch

from repro.core import lut as ref_lut
from repro_torch.core import lut as port_lut

from _xfw import assert_equal, np_of

pytestmark = pytest.mark.tier1

NBITS = (2, 3, 4)
SHAPES = [(16, 8), (17, 5), (1, 3), (33, 7), (3, 9, 6), (2, 3, 13, 4)]


@pytest.mark.parametrize("nbits", NBITS)
@pytest.mark.parametrize("d_in", [1, 2, 3, 7, 8, 9, 31, 130, 4096, 11008])
def test_row_arithmetic_matches_reference(nbits, d_in):
    assert port_lut.padded_d_in(d_in, nbits) == ref_lut.padded_d_in(d_in, nbits)
    assert port_lut.packed_rows(d_in, nbits) == ref_lut.packed_rows(d_in, nbits)
    assert port_lut.packed_rows(d_in, nbits) * 8 == port_lut.padded_d_in(d_in, nbits) * nbits


def test_width_tables_match_reference():
    assert port_lut.SUPPORTED_NBITS == ref_lut.SUPPORTED_NBITS
    assert port_lut.CODES_PER_GROUP == ref_lut.CODES_PER_GROUP
    assert port_lut.BYTES_PER_GROUP == ref_lut.BYTES_PER_GROUP


@pytest.mark.parametrize("nbits", NBITS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pack_is_byte_identical(nbits, shape):
    rng = np.random.default_rng(hash((nbits, shape)) % 2**32)
    codes = rng.integers(0, 1 << nbits, size=shape).astype(np.uint8)
    got = port_lut.pack_codes(codes, nbits)
    want = ref_lut.pack_codes(codes, nbits)
    assert got.dtype == np.uint8
    assert_equal(got, want, f"pack_codes nbits={nbits} shape={shape}")


@pytest.mark.parametrize("nbits", NBITS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_unpack_matches_reference_and_round_trips(nbits, shape):
    rng = np.random.default_rng(hash((shape, nbits)) % 2**32)
    codes = rng.integers(0, 1 << nbits, size=shape).astype(np.uint8)
    d_in = shape[-2]
    packed = ref_lut.pack_codes(codes, nbits)
    got = port_lut.unpack_codes(torch.from_numpy(packed), d_in, nbits)
    assert got.dtype == torch.int32
    assert_equal(np_of(got), np.asarray(ref_lut.unpack_codes(packed, d_in, nbits)),
                 "unpack_codes vs reference")
    assert_equal(np_of(got), codes.astype(np.int32), "unpack(pack(codes)) == codes")


@pytest.mark.parametrize("nbits", NBITS)
def test_random_bytes_are_valid_streams(nbits):
    """What materialize_clustered relies on: any byte tensor unpacks to codes
    below 2**nbits, and to the reference's codes."""
    rng = np.random.default_rng(nbits)
    d_in = 64
    packed = rng.integers(0, 256, (port_lut.packed_rows(d_in, nbits), 9)).astype(np.uint8)
    got = np_of(port_lut.unpack_codes(torch.from_numpy(packed), d_in, nbits))
    assert got.max() < (1 << nbits) and got.min() >= 0
    assert_equal(got, np.asarray(ref_lut.unpack_codes(packed, d_in, nbits)), "random bytes")


def test_pinned_errors_match_reference():
    for mod in (port_lut, ref_lut):
        with pytest.raises(ValueError, match=r"nbits must be one of \(2, 3, 4\); got 5"):
            mod.padded_d_in(8, 5)
        with pytest.raises(ValueError, match=r"codes must fit in 2 bits \(K <= 4\); got max code 7"):
            mod.pack_codes(np.full((4, 4), 7, np.uint8), 2)
    packed = np.zeros((5, 4), np.uint8)
    with pytest.raises(ValueError) as port_err:
        port_lut.unpack_codes(torch.from_numpy(packed), 16, 4)
    with pytest.raises(ValueError) as ref_err:
        ref_lut.unpack_codes(packed, 16, 4)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("nbits", NBITS)
def test_dequant_ref_matches_reference(nbits):
    rng = np.random.default_rng(7 + nbits)
    q = rng.integers(-127, 128, (5, 24)).astype(np.int8)
    codes = rng.integers(0, 1 << nbits, (24, 11)).astype(np.int32)
    cb = np.sort(rng.normal(size=16)).astype(np.float32)
    want = np.asarray(ref_lut.lut_matmul_dequant_ref(q, codes, cb, np.float32(0.03)))
    got = np_of(port_lut.lut_matmul_dequant_ref(
        torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(cb), 0.03))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
