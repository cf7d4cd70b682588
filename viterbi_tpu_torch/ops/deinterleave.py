"""Kernel K, the outer deinterleaver of T-DMB: the I = 12, M = 17
convolutional (Forney) byte deinterleaver of ETSI EN 300 744 clause 4.3.2
that ETSI TS 102 427 puts around an MPEG-2 transport stream in a DAB
stream-mode subchannel.

Byte n of a stream takes branch j = n mod 12. The transmitter delays
branch j by j * 17 bytes of its own, the receiver by (11 - j) * 17, so a
deinterleaved byte is the transmitted stream's byte n - 2244, eleven
204-byte packets back. The receiver's state is its FIFOs, 1122 bytes a
stream (``CARRY_BYTES``): branch j's (11 - j) * 17 newest bytes, oldest
first, at ``branch_offsets()[j]``. A fresh stream's FIFOs hold zeros.

``deinterleave(data, carry)`` runs a call's bytes of S streams, uint8[S,
L] with L a multiple of 204, against the previous call's FIFOs
(``carry`` uint8[S, 1122], None for fresh streams) and returns the
codewords uint8[S, L] and the FIFOs after the call. Calls that continue
each other give, byte for byte, what one call over the whole stream
gives. On a CUDA tensor it launches kernel K (``csrc/deinterleave.cu``)
once; on a CPU tensor it runs ``deinterleave_plain``, one torch gather
from the FIFOs followed by the call's bytes.
"""

from __future__ import annotations

import functools

import torch

from . import _build

BRANCHES = 12
DEPTH = 17
#: a transport stream packet: the codeword length, BRANCHES * DEPTH
PACKET = BRANCHES * DEPTH
#: bytes a stream's FIFOs hold between calls
CARRY_BYTES = DEPTH * BRANCHES * (BRANCHES - 1) // 2
#: the deinterleaved stream's delay behind the transmitted one, in bytes
DELAY = (BRANCHES - 1) * PACKET
#: threads a block of kernel K
THREADS = 256


@functools.lru_cache(maxsize=1)
def branch_offsets() -> tuple:
    """Where branch j's FIFO starts in a stream's carry, j = 0 .. 12."""
    out, at = [], 0
    for j in range(BRANCHES + 1):
        out.append(at)
        at += (BRANCHES - 1 - j) * DEPTH if j < BRANCHES else 0
    return tuple(out)


def _check(data: torch.Tensor, carry) -> None:
    if data.dim() != 2 or data.shape[1] % PACKET:
        raise ValueError(f"data must be [S, L] with L a multiple of "
                         f"{PACKET}, got {list(data.shape)}")
    if data.dtype != torch.uint8:
        raise TypeError(f"deinterleave reads uint8 bytes, got {data.dtype}")
    if carry is not None and (
            tuple(carry.shape) != (data.shape[0], CARRY_BYTES)
            or carry.dtype != torch.uint8 or carry.device != data.device):
        raise ValueError(f"carry must be uint8[{data.shape[0]}, "
                         f"{CARRY_BYTES}] on {data.device}, got "
                         f"{carry.dtype} {list(carry.shape)} on "
                         f"{carry.device}")


@functools.lru_cache(maxsize=16)
def _gather_index(L: int, device) -> tuple:
    """(out index [L], carry index [1122]) into a stream's FIFOs followed
    by its L new bytes."""
    off = torch.tensor(branch_offsets(), device=device)
    n = torch.arange(L, device=device)
    j = n % BRANCHES
    m = n - (BRANCHES - 1 - j) * PACKET
    out = torch.where(m >= 0, CARRY_BYTES + m,
                      off[j] + torch.div(n - j, BRANCHES,
                                         rounding_mode="floor"))
    e = torch.arange(CARRY_BYTES, device=device)
    jb = torch.bucketize(e, off[1:BRANCHES], right=True)
    r = e - off[jb]
    m2 = L - (BRANCHES - 1 - jb) * PACKET + jb + BRANCHES * r
    carry = torch.where(m2 >= 0, CARRY_BYTES + m2, e + L // BRANCHES)
    return out, carry


def deinterleave_plain(data: torch.Tensor, carry: torch.Tensor | None = None):
    """Plain version of kernel K on any device: one gather from each
    stream's FIFOs followed by its new bytes. Same arguments and results
    as ``deinterleave``."""
    _check(data, carry)
    S, L = data.shape
    if carry is None:
        carry = data.new_zeros((S, CARRY_BYTES))
    ext = torch.cat([carry, data], dim=1)
    idx_out, idx_carry = _gather_index(L, data.device)
    return ext[:, idx_out], ext[:, idx_carry]


def deinterleave(data: torch.Tensor, carry: torch.Tensor | None = None):
    """Deinterleave S streams: ``data`` uint8[S, L] (L a multiple of 204;
    rows any distance apart, bytes contiguous) and ``carry`` uint8[S,
    1122] (the previous call's FIFOs, None for fresh streams) -> (out
    uint8[S, L], the FIFOs after the call uint8[S, 1122]) on its device.

    Kernel K on a CUDA tensor, one launch; ``deinterleave_plain`` on a CPU
    tensor."""
    if data.device.type == "cpu":
        return deinterleave_plain(data, carry)
    if data.device.type != "cuda":
        raise ValueError(f"deinterleave: unsupported device {data.device}")
    _check(data, carry)
    if data.shape[1] and data.stride(1) != 1:
        data = data.contiguous()
    if carry is not None and not carry.is_contiguous():
        carry = carry.contiguous()
    S, L = data.shape
    dev = data.device
    out = torch.empty((S, L), dtype=torch.uint8, device=dev)
    carry_out = torch.empty((S, CARRY_BYTES), dtype=torch.uint8, device=dev)
    if S == 0:
        return out, carry_out
    _build.DEINTERLEAVE.launch(
        dev, data.data_ptr(), data.stride(0) if S > 1 else L, L, S,
        None if carry is None else carry.data_ptr(), out.data_ptr(),
        carry_out.data_ptr(), THREADS)
    return out, carry_out
