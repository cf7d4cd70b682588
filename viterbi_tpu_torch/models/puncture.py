"""DAB convolutional puncturing (ETSI EN 300 401 §11).

The port's numpy copy of ``viterbi_tpu.models.puncture``, pinned to it
mask for mask by ``tests/test_torch_puncture.py``. The reference DLL
receives already-depunctured rate-1/4 symbol streams (QIRX depunctures
upstream; the reference has no puncture tables), so the full EEP profile
system lives here.

Structure (EN 300 401):

* The K=7 rate-1/4 mother code emits 4 bits per input bit; a 24 ms
  logical frame of I data bits yields ``4*I`` mother bits plus 24 tail
  bits (6 zero-flush steps).
* The mother stream is split into 128-bit blocks (4 applications of a
  32-bit puncturing vector). Puncturing index PI in 1..24 keeps
  ``8 + PI`` of every 32 bits, so PI=8 is rate 1/2 and PI=24 is the
  unpunctured mother code.
* The 24 tail bits are punctured with the tail vector V_T (12 kept).
* A protection profile is a list of segments ``(L_j blocks, PI_j)``.

The 32-bit vectors are generated, not tabulated: every vector keeps the
first column of each 4-bit group (the 8 "survivor" positions of the
highest-rate code), and each PI increment adds one more position,
filling column by column through the groups in bit-reversed order
(0,4,2,6,1,5,3,7). The EEP segment tables below are pinned by exact
arithmetic: for every profile the kept-bit count works out to
``I / rate`` including the 12-bit punctured tail, which the tests
assert for all profiles and bitrates.

Depuncturing inserts a neutral soft value (127, the closest integer to
the 127.5 offset-binary midpoint) at punctured positions, giving equal
branch-metric contribution to both bit polarities up to the reference's
pavgb rounding.

UEP (classic DAB audio, EN 300 401 table 31) is structurally a
four-segment ``Profile``: construct
``Profile("UEP ...", ((L1, PI1), (L2, PI2), (L3, PI3), (L4, PI4)))``
with a row from the standard's table. The 64-row UEP table itself is
not vendored here (no offline source to pin it against — the EEP tables
below are pinned by exact rate arithmetic, which UEP rows don't admit);
everything downstream (mask/puncture/depuncture/decode) is
segment-count-agnostic.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .. import constants as C

#: Neutral soft value for punctured positions (offset binary midpoint).
NEUTRAL_SOFT = 127

#: Group fill order for vector generation: bit-reversed 0..7.
_GROUP_ORDER = (0, 4, 2, 6, 1, 5, 3, 7)


@functools.lru_cache(maxsize=1)
def puncturing_vectors() -> np.ndarray:
    """All 24 puncturing vectors as uint8[25, 32] (row PI, rows 1..24).

    Row 0 is the hypothetical PI=0 base (first column only), kept so
    ``puncturing_vectors()[pi]`` indexes naturally by PI.
    """
    vec = np.zeros((25, 32), dtype=np.uint8)
    vec[:, 0::4] = 1                       # base: column 0 of each group
    fills = [(col, g) for col in (1, 2, 3) for g in _GROUP_ORDER]
    for pi in range(1, 25):
        vec[pi] = vec[pi - 1]
        col, g = fills[pi - 1]
        vec[pi, 4 * g + col] = 1
    assert (vec.sum(axis=1) == 8 + np.arange(25)).all()
    return vec


#: Tail puncturing vector V_T over the 24 tail mother bits (12 kept).
TAIL_VECTOR = np.tile(np.array([1, 1, 0, 0], dtype=np.uint8), 6)


@dataclasses.dataclass(frozen=True)
class Profile:
    """A protection profile: segments of 128-bit blocks with their PI."""
    name: str
    segments: tuple[tuple[int, int], ...]   # ((blocks, PI), ...)

    def mask(self) -> np.ndarray:
        """Transmission mask over the full mother stream.

        uint8[4*I + 24]: 1 = transmitted, 0 = punctured. ``4*I`` =
        128 * total blocks; the last 24 entries are the tail vector.
        """
        vec = puncturing_vectors()
        parts = [np.tile(vec[pi], 4 * blocks)
                 for blocks, pi in self.segments]
        parts.append(TAIL_VECTOR)
        return np.concatenate(parts)

    @property
    def data_bits(self) -> int:
        """I: data bits per logical frame (32 per 128-bit block)."""
        return 32 * sum(blocks for blocks, _ in self.segments)

    @property
    def transmitted_bits(self) -> int:
        return int(self.mask().sum())


def eep_profile(bitrate_kbps: int, level: int, profile: str = "A") -> Profile:
    """Equal Error Protection profile (EN 300 401 tables 33/34).

    ``level`` 1..4; profile "A" for bitrates that are multiples of 8
    (code rates 1/4, 3/8, 1/2, 3/4), "B" for multiples of 32 (rates
    4/9, 4/7, 2/3, 4/5). Segment lengths are in 128-bit blocks; a
    logical frame has ``I/32 = 6n`` (A, n = bitrate/8) or ``24n`` (B,
    n = bitrate/32) blocks.
    """
    if profile == "A":
        if bitrate_kbps % 8:
            raise ValueError("EEP-A needs a multiple of 8 kbit/s")
        n = bitrate_kbps // 8
        if level == 2 and n == 1:          # 8 kbit/s special case
            segs = ((5, 13), (1, 12))
        else:
            table = {
                1: ((6 * n - 3, 24), (3, 23)),
                2: ((2 * n - 3, 14), (4 * n + 3, 13)),
                3: ((6 * n - 3, 8), (3, 7)),
                4: ((4 * n - 3, 3), (2 * n + 3, 2)),
            }
            segs = table[level]
    elif profile == "B":
        if bitrate_kbps % 32:
            raise ValueError("EEP-B needs a multiple of 32 kbit/s")
        n = bitrate_kbps // 32
        pi1 = {1: 10, 2: 6, 3: 4, 4: 2}[level]
        segs = ((24 * n - 3, pi1), (3, pi1 - 1))
    else:
        raise ValueError(f"unknown EEP profile {profile!r}")
    if any(blocks <= 0 for blocks, _ in segs):
        raise ValueError(
            f"bitrate {bitrate_kbps} too low for EEP {level}-{profile}")
    return Profile(f"EEP {level}-{profile} @{bitrate_kbps}", segs)


def uep_profile_from_row(bitrate_kbps: int, protection_level: int,
                         segments, cu_size: int | None = None) -> Profile:
    """Build a UEP profile from a transcribed EN 300 401 table 31 row.

    UEP (classic DAB audio) rows are four/five-segment
    ``((L_1, PI_1), ..., (L_n, PI_n))`` entries in 128-bit blocks. The
    64-row table itself is NOT vendored (no offline source to pin a
    transcription against); this constructor instead validates a
    caller-supplied row
    with every self-check the standard's structure admits:

      * every segment length positive, every PI in 1..24,
      * the row covers exactly one logical frame:
        ``sum(L_j) * 128 == 4 * I`` with ``I = 24 * bitrate`` (so the
        mask, with the 24 tail bits, is exactly ``4*I + 24`` long),
      * optionally, ``cu_size`` (the sub-channel size in capacity
        units from EN 300 401 table 7) cross-checks the transmitted
        bit count: ``mask.sum() == 64 * cu_size`` — a transcription
        error in any PI or L is caught by this equality.

    Provenance marking: the profile name records bitrate/level and that
    the row was user-supplied.
    """
    segments = tuple((int(l), int(pi)) for l, pi in segments)
    if not segments:
        raise ValueError("UEP row needs at least one segment")
    for l, pi in segments:
        if l <= 0:
            raise ValueError(f"non-positive segment length {l}")
        if not 1 <= pi <= 24:
            raise ValueError(f"PI {pi} outside 1..24")
    framebits = 24 * bitrate_kbps
    covered = 32 * sum(l for l, _ in segments)
    if covered != framebits:
        raise ValueError(
            f"row covers {covered} data bits, frame has {framebits} "
            f"(sum(L)*128 must equal 4*I)")
    p = Profile(f"UEP L{protection_level} @{bitrate_kbps} (user row)",
                segments)
    assert p.mask().size == C.RATE * framebits + 24
    if cu_size is not None and p.transmitted_bits != 64 * cu_size:
        raise ValueError(
            f"row transmits {p.transmitted_bits} bits but table 7 says "
            f"{64 * cu_size} (CU {cu_size}); a PI or L is mistranscribed")
    return p


#: Exact code rate (data bits / transmitted bits) per EEP profile.
EEP_RATES = {
    ("A", 1): (1, 4), ("A", 2): (3, 8), ("A", 3): (1, 2), ("A", 4): (3, 4),
    ("B", 1): (4, 9), ("B", 2): (4, 7), ("B", 3): (2, 3), ("B", 4): (4, 5),
}


def puncture(mother: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Keep the transmitted positions of a mother stream.

    ``mother``: [..., 4*I+24] mother-code symbols (hard bits or soft);
    returns [..., mask.sum()].
    """
    mask = np.asarray(mask, dtype=bool)
    return np.asarray(mother)[..., mask]


def depuncture(received: np.ndarray, mask: np.ndarray,
               fill: int = NEUTRAL_SOFT) -> np.ndarray:
    """Expand a punctured soft stream back to the full mother stream.

    ``received``: [..., mask.sum()] soft symbols; punctured positions
    are filled with ``fill``. Returns [..., len(mask)] — the rate-1/4
    layout ``deconvolve`` consumes (4*(framebits+6) entries).
    """
    mask = np.asarray(mask, dtype=bool)
    received = np.asarray(received)
    assert received.shape[-1] == int(mask.sum()), (
        received.shape, int(mask.sum()))
    out = np.full(received.shape[:-1] + (mask.size,), fill,
                  dtype=received.dtype)
    out[..., mask] = received
    return out


def frame_mask(bitrate_kbps: int, level: int, profile: str = "A",
               framebits: int | None = None) -> np.ndarray:
    """Mask for one logical frame of a subchannel; checks geometry."""
    p = eep_profile(bitrate_kbps, level, profile)
    if framebits is None:
        framebits = 24 * bitrate_kbps
    assert p.data_bits == framebits, (p.data_bits, framebits)
    m = p.mask()
    assert m.size == C.RATE * (framebits + C.TAIL_BITS)
    return m
