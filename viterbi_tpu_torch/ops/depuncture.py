"""Kernel J, depuncturing: punctured soft symbols -> the rate-1/4 mother
stream as the frame-major packed words that kernel A reads.

A protection profile (``models.puncture.Profile``) keeps ``kept`` of the
``4*(I+6)`` mother-code symbols of a logical frame of I data bits. The
receiver hands over the kept ones; ``depuncture`` puts each back at its
mother position and the neutral soft value (``puncture.NEUTRAL_SOFT``,
127) at every punctured one, one byte a symbol: uint8[N, 4*(I+6)], byte
for byte the ``packed="bt"`` words of ``acs_cuda.decode`` (symbol q of a
step in byte q of its word).

The profile comes to the device as a table of one int32 a trellis step
(``step_table``): the step's four mask bits in bits 0-3 and, above them,
the index of its first kept symbol among the frame's kept symbols, so a
step's kept symbols are the next popcount(mask) after that index. The
table is made once per profile and device.

On a CUDA tensor ``depuncture`` launches kernel J (``csrc/depuncture.cu``);
on a CPU tensor it runs
``depuncture_plain``, a torch gather through the same table. The input
is uint8 (the staged ingest's bytes) or int32 (the direct ingest's
symbols, of which the low byte counts, as in kernel A's load); other
integer types are cast to int32 first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from ..models import puncture as P
from . import _build

#: threads a block of kernel J (steps of a frame across a block's threads)
THREADS = 128
#: mask bits of a step in its table entry; the kept index sits above them
MASK_BITS = 4


@functools.lru_cache(maxsize=64)
def _host_table(segments: tuple) -> tuple[np.ndarray, int]:
    """(int32[T] step table, kept symbols a frame) of a profile's
    segments."""
    mask = P.Profile("table", segments).mask().astype(np.int64)
    steps = mask.reshape(-1, C.RATE)
    bits = steps @ (1 << np.arange(C.RATE))
    first = np.concatenate([[0], np.cumsum(steps.sum(axis=1))[:-1]])
    table = (first << MASK_BITS) | bits
    return table.astype(np.int32), int(mask.sum())


_tables: dict = {}


def step_table(profile: P.Profile, device) -> torch.Tensor:
    """A profile's step table on ``device``, made at its first use there."""
    key = (profile.segments, torch.device(device))
    table = _tables.get(key)
    if table is None:
        table = _tables[key] = torch.from_numpy(
            _host_table(profile.segments)[0]).to(device)
    return table


def _check(received: torch.Tensor, profile: P.Profile) -> None:
    kept = _host_table(profile.segments)[1]
    if received.dim() != 2 or received.shape[1] != kept:
        raise ValueError(f"received must be [N, {kept}] for {profile.name}, "
                         f"got {list(received.shape)}")


def depuncture_plain(received: torch.Tensor,
                     profile: P.Profile) -> torch.Tensor:
    """Plain version of kernel J on any device: the same step table read
    by a torch gather. Same arguments and result as ``depuncture``."""
    _check(received, profile)
    table = step_table(profile, received.device).to(torch.int64)
    first, bits = table >> MASK_BITS, table & ((1 << MASK_BITS) - 1)
    sym = received.to(torch.uint8)
    # a pad column, so a punctured position's index stays in range
    padded = torch.cat([sym, sym.new_full((sym.shape[0], 1),
                                          P.NEUTRAL_SOFT)], dim=1)
    cols, before = [], torch.zeros_like(first)
    for q in range(C.RATE):
        sent = (bits >> q) & 1
        cols.append(torch.where(sent == 1, first + before, sym.shape[1]))
        before = before + sent
    index = torch.stack(cols, dim=1).reshape(-1)
    return padded[:, index]


def depuncture(received: torch.Tensor, profile: P.Profile) -> torch.Tensor:
    """Depuncture N frames of one profile: ``received`` [N, kept] (uint8
    or int32; the low byte of each symbol counts) -> uint8[N, 4*(I+6)]
    on its device, the kept symbols at their mother positions and 127
    at the punctured ones.

    Kernel J on a CUDA tensor (rows any distance apart), one launch;
    ``depuncture_plain`` on a CPU tensor."""
    if received.device.type == "cpu":
        return depuncture_plain(received, profile)
    if received.device.type != "cuda":
        raise ValueError(f"depuncture: unsupported device {received.device}")
    _check(received, profile)
    if received.dtype not in (torch.uint8, torch.int32):
        received = received.to(torch.int32)
    if received.stride(1) != 1:
        received = received.contiguous()
    dev = received.device
    table = step_table(profile, dev)
    n, steps = received.shape[0], table.numel()
    out = torch.empty((n, C.RATE * steps), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    elem = received.element_size()
    _build.DEPUNCTURE.launch(
        dev, received.data_ptr(), received.stride(0) * elem, elem,
        table.data_ptr(), steps, n, out.data_ptr(), THREADS)
    return out
