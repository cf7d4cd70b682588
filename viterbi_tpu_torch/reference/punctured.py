"""Plain reference of the DAB+ superframe chain fed punctured symbols,
as a receiver takes them from the Main Service Channel (MSC).

What ``models.dab.decode_audio_superframes(..., protection=...)`` must
give, written from the standards and kept apart from the port: plain
torch for the depuncturing, the golden scalar models (``golden.py``) for
the Viterbi decode and RS(120,110); no op, kernel or placement code of
the port, and not its puncturing tables (``models/puncture.py``).

* The puncturing vectors (ETSI EN 300 401 §11.1.2, table 29): vector PI
  keeps 8 + PI of 32 mother-code bits. Its 32 bits are 8 groups of 4;
  bit 0 of every group is always kept, and bits 1, 2 and 3 join the
  groups in the order 0, 4, 2, 6, 1, 5, 3, 7, bit 1 for PI 1-8, bit 2
  for PI 9-16, bit 3 for PI 17-24. Written here as that rule, not as
  the table's 24 rows.
* The tail (§11.1.2): 24 mother bits, kept by V_T = 1100 repeated.
* The EEP profiles (§11.3.2, tables 33 and 34): two segments of 128-bit
  blocks with their PI; EEP-A n = bitrate / 8 (level 2 at 8 kbit/s its
  own row), EEP-B n = bitrate / 32.
* Depuncturing puts each received symbol at its kept position and the
  neutral soft value 127 at the punctured ones, then the terminated
  decode (golden) and the superframe's RS check follow.

Departures from the standard: the symbols are the MSC's soft bits after
the OFDM demodulator and the time de-interleaver, which lie upstream of
this chain; energy dispersal and the subchannel's place in the CIF are
upstream too. The audio keeps every codeword as decoded, a failed one
included (the chain's form; RScheckSuperframe zeroes from the first
failure), and ``errors`` is -1 where any codeword failed.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import golden

RATE = 4
TAIL_BITS = 6
NEUTRAL = 127
SUPERFRAME_FRAMES = 5
RS_N, RS_KK = 120, 110
#: the groups of a puncturing vector in the order their bits join
GROUP_ORDER = (0, 4, 2, 6, 1, 5, 3, 7)


def vector(pi: int) -> torch.Tensor:
    """bool[32]: the bits of puncturing vector PI (1..24) that are kept."""
    if not 1 <= pi <= 24:
        raise ValueError(f"PI {pi} outside 1..24")
    keep = torch.zeros((8, 4), dtype=torch.bool)
    keep[:, 0] = True
    for bit in (1, 2, 3):
        for rank, group in enumerate(GROUP_ORDER):
            if pi >= 8 * (bit - 1) + rank + 1:
                keep[group, bit] = True
    return keep.reshape(32)


def eep_segments(bitrate_kbps: int, profile: str, level: int):
    """((blocks, PI), (blocks, PI)) of an EEP profile (tables 33, 34)."""
    if profile == "A":
        if bitrate_kbps % 8:
            raise ValueError("EEP-A takes multiples of 8 kbit/s")
        n = bitrate_kbps // 8
        if level == 2 and n == 1:
            return ((5, 13), (1, 12))
        return {1: ((6 * n - 3, 24), (3, 23)),
                2: ((2 * n - 3, 14), (4 * n + 3, 13)),
                3: ((6 * n - 3, 8), (3, 7)),
                4: ((4 * n - 3, 3), (2 * n + 3, 2))}[level]
    if profile == "B":
        if bitrate_kbps % 32:
            raise ValueError("EEP-B takes multiples of 32 kbit/s")
        n = bitrate_kbps // 32
        pi = {1: 10, 2: 6, 3: 4, 4: 2}[level]
        return ((24 * n - 3, pi), (3, pi - 1))
    raise ValueError(f"no EEP profile {profile!r}")


def mask(bitrate_kbps: int, protection) -> torch.Tensor:
    """bool[4 * (24 * bitrate + 6)]: the kept mother-code positions of a
    logical frame under ``protection`` = (profile, level)."""
    profile, level = protection
    parts = [vector(pi).repeat(4 * blocks)
             for blocks, pi in eep_segments(bitrate_kbps, profile, level)]
    parts.append(torch.tensor([True, True, False, False]).repeat(6))
    out = torch.cat(parts)
    if out.numel() != RATE * (24 * bitrate_kbps + TAIL_BITS):
        raise ValueError(f"EEP {level}-{profile} does not cover "
                         f"{bitrate_kbps} kbit/s")
    return out


def depuncture(received: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """[..., kept] soft symbols -> int64[..., keep.numel()]: each at its
    kept position, 127 elsewhere."""
    received = torch.as_tensor(received)
    if received.shape[-1] != int(keep.sum()):
        raise ValueError(f"received has {received.shape[-1]} symbols a "
                         f"frame, the mask keeps {int(keep.sum())}")
    out = torch.full(received.shape[:-1] + (keep.numel(),), NEUTRAL,
                     dtype=torch.int64)
    out[..., keep] = received.to(torch.int64)
    return out


def check_superframe(sf: np.ndarray, rs_dims: int):
    """(errors, audio uint8[rs_dims * 110]) of one byte-interleaved
    superframe: each codeword as golden decodes it, -1 if any fails."""
    audio = np.zeros(rs_dims * RS_KK, np.uint8)
    errors = 0
    for j in range(rs_dims):
        count, corrected = golden.rs_decode_codeword(sf[j::rs_dims][:RS_N])
        errors = -1 if count < 0 or errors < 0 else errors + count
        audio[j::rs_dims] = corrected[:RS_KK]
    return errors, audio


def decode_superframes(received, bitrate_kbps: int, protection):
    """The chain on punctured superframes: int[B, 5, kept] (the low byte
    of each symbol counts) -> (audio uint8[B, rs_dims*110], errors
    int32[B]) as CPU tensors."""
    framebits = 24 * bitrate_kbps
    rs_dims = SUPERFRAME_FRAMES * framebits // 8 // RS_N
    rec = torch.as_tensor(np.asarray(received)) & 255
    full = depuncture(rec, mask(bitrate_kbps, protection))
    B = full.shape[0]
    frames = golden.deconvolve_many(
        framebits, full.reshape(B * SUPERFRAME_FRAMES, -1).numpy())
    audio = np.zeros((B, rs_dims * RS_KK), np.uint8)
    errors = np.zeros(B, np.int32)
    for b, sf in enumerate(frames.reshape(B, -1)):
        errors[b], audio[b] = check_superframe(sf, rs_dims)
    return torch.from_numpy(audio), torch.from_numpy(errors)
