"""Kernel J's least time: the depuncture stage's bytes at the card's
memory rate, from the call's geometry alone (not the program's
counters), so that the yardstick cannot move with the program.

A frame of I data bits under an EEP profile: its kept symbols read once,
one byte each (the staged ingest's form), and its 4 * (I + 6) mother-code
bytes written once; the profile's step table (4 bytes a step, the same
for every frame) stays in the cache and is not counted. The masks are the
benchmark's own (``gen/channel.eep_mask``); the memory rate is
``roofline.HBM_BYTES_S``.
"""

from __future__ import annotations

from .gen import channel
from .roofline import HBM_BYTES_S, TAIL_BITS

RATE = 4


def frame_bytes(kbps: int, protection) -> int:
    """Bytes kernel J must move for one frame at ``kbps`` under
    ``protection`` = (profile, level): kept in, mother stream out."""
    profile, level = protection
    kept = int(channel.eep_mask(kbps, level, profile).sum())
    return kept + RATE * (24 * kbps + TAIL_BITS)


def depuncture_bound(frames: int, kbps: int, protection) -> float:
    """Seconds: ``frames`` frames' bytes over the memory rate."""
    return frames * frame_bytes(kbps, protection) / HBM_BYTES_S
