"""The port's puncturing module against the JAX package's: vectors, every
EEP mask over the DAB bitrates, the user-row checks, and puncture /
depuncture. Tolerance zero: masks are equal element for element."""

import numpy as np
import pytest

import viterbi_tpu.models.puncture as JP
import viterbi_tpu_torch.models.puncture as TP

BITRATES = (8, 32, 64, 96, 128, 192, 384)
EEP = [(level, prof) for prof in "AB" for level in (1, 2, 3, 4)]


def test_vectors_and_constants_match():
    assert np.array_equal(TP.puncturing_vectors(), JP.puncturing_vectors())
    assert np.array_equal(TP.TAIL_VECTOR, JP.TAIL_VECTOR)
    assert TP.NEUTRAL_SOFT == JP.NEUTRAL_SOFT
    assert TP.EEP_RATES == JP.EEP_RATES
    assert TP._GROUP_ORDER == JP._GROUP_ORDER


@pytest.mark.parametrize("level,prof", EEP)
@pytest.mark.parametrize("kbps", BITRATES)
def test_every_eep_mask_matches(kbps, level, prof):
    if prof == "B" and kbps % 32:
        for mod in (TP, JP):
            with pytest.raises(ValueError, match="multiple of 32"):
                mod.eep_profile(kbps, level, prof)
        return
    want, got = JP.eep_profile(kbps, level, prof), TP.eep_profile(kbps, level,
                                                                  prof)
    assert (got.name, got.segments) == (want.name, want.segments)
    assert got.data_bits == want.data_bits == 24 * kbps
    assert got.transmitted_bits == want.transmitted_bits
    mask = TP.frame_mask(kbps, level, prof)
    assert mask.dtype == np.uint8
    assert np.array_equal(mask, JP.frame_mask(kbps, level, prof))
    # the exact code rate, the kept tail bits included
    num, den = TP.EEP_RATES[(prof, level)]
    assert got.transmitted_bits * num == 24 * kbps * den


def test_profile_errors_match():
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="multiple of 8"):
            mod.eep_profile(12, 1, "A")
        with pytest.raises(ValueError, match="unknown EEP profile"):
            mod.eep_profile(32, 1, "C")
    assert TP.eep_profile(8, 2, "A").segments == ((5, 13), (1, 12))


ROW = ((6, 24), (10, 16), (5, 9), (3, 5))        # 24 blocks = 32 kbit/s


def test_uep_row_matches_and_is_checked():
    want = JP.uep_profile_from_row(32, 3, ROW)
    got = TP.uep_profile_from_row(32, 3, ROW)
    assert (got.name, got.segments) == (want.name, want.segments)
    assert np.array_equal(got.mask(), want.mask())
    cu = got.transmitted_bits // 64
    if got.transmitted_bits % 64 == 0:
        assert TP.uep_profile_from_row(32, 3, ROW, cu_size=cu) == got
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="at least one"):
            mod.uep_profile_from_row(32, 3, ())
        with pytest.raises(ValueError, match="non-positive"):
            mod.uep_profile_from_row(32, 3, ((0, 5), (24, 5)))
        with pytest.raises(ValueError, match="outside 1..24"):
            mod.uep_profile_from_row(32, 3, ((24, 25),))
        with pytest.raises(ValueError, match="row covers"):
            mod.uep_profile_from_row(32, 3, ROW[:3])
        with pytest.raises(ValueError, match="mistranscribed"):
            mod.uep_profile_from_row(32, 3, ROW, cu_size=1)


@pytest.mark.parametrize("level,prof", [(3, "A"), (2, "B")])
def test_puncture_and_depuncture_match(level, prof):
    mask = TP.frame_mask(32, level, prof)
    mother = np.random.default_rng(level).integers(0, 256, (3, mask.size))
    kept = TP.puncture(mother, mask)
    assert np.array_equal(kept, JP.puncture(mother, mask))
    full = TP.depuncture(kept, mask)
    assert np.array_equal(full, JP.depuncture(kept, mask))
    assert np.array_equal(full[:, mask == 1], kept)
    assert (full[:, mask == 0] == TP.NEUTRAL_SOFT).all()
    assert np.array_equal(TP.depuncture(kept, mask, fill=0),
                          JP.depuncture(kept, mask, fill=0))
