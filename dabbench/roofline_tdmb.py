"""The least time of the T-DMB chain's outer stages, from the calls'
geometry alone (not the program's counters), so that the yardstick
cannot move with the program.

* Kernel K (the I = 12 deinterleaver): a call's decoded bytes read once
  and its codewords written once, 204 bytes a packet each way, and each
  stream's 1122 bytes of FIFOs written, and read where the call
  continues a stream, at the card's memory rate.
* Kernel I's RS(204,188) entry, the way ``roofline.rs_superframes_bound``
  counts kernel I: each codeword's 204 bytes read, its 188 data bytes
  and an int32 count written, and its syndromes as the 1632 x 128 GF(2)
  product on the int8 tensor cores (two operations a bit product, as
  ``roofline.OPS_RS_SYND_TENSOR`` counts 960 x 80). The dirty codewords'
  Berlekamp-Massey, Chien search and Forney are left out, so the bound
  is lower than the work, never above it.

The rates are ``roofline``'s (NVIDIA's H100 SXM data sheet, at 700 W).
"""

from __future__ import annotations

from .roofline import HBM_BYTES_S, bound

N, K = 204, 188
NROOTS = 16
CARRY_BYTES = 1122
PACKET_KBPS = 68
#: the syndromes' GF(2) product a codeword, two operations a bit product
OPS_RS204_SYND_TENSOR = 2 * (8 * N) * (8 * NROOTS)


def packets(call, kbps: int) -> int:
    """The 204-byte packets a call decodes: p a CIF a stream."""
    return call.streams * call.cifs * (kbps // PACKET_KBPS)


def deinterleave_bound(call, kbps: int) -> float:
    """Seconds: kernel K's bytes for one call at the memory rate."""
    data = packets(call, kbps) * N
    carry = call.streams * CARRY_BYTES * (2 if call.part else 1)
    return (2 * data + carry) / HBM_BYTES_S


def rs_packets_bound(call, kbps: int, clock_hz: float) -> float:
    """Seconds: kernel I's RS(204,188) entry for one call's codewords."""
    n = packets(call, kbps)
    return bound(n * (N + K + 4), 0.0, clock_hz,
                 tensor_ops=n * OPS_RS204_SYND_TENSOR)
