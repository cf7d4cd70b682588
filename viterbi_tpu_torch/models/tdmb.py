"""The T-DMB stream-mode chain: MPEG-2 transport streams carried in DAB
stream-mode subchannels (ETSI TS 102 427, the transport under T-DMB video,
ETSI TS 102 428), decoded on the device end to end:

    the MSC's punctured soft bytes of S streams over T CIFs
      -> byte ingest                 (runtime.placement.ingest_bytes)
      -> depuncture, EEP profile     (ops.depuncture, kernel J)
      -> Viterbi, framebits 24 kbps  (models.dab.decode_frames, A and B)
      -> outer deinterleave, I = 12  (ops.deinterleave, kernel K)
      -> RS(204,188)                 (ops.rs.rs_decode_packets, kernel I)
      -> 188-byte packets and their corrected-byte counts

A stream at ``bitrate_kbps`` = 68 p kbit/s carries p whole 204-byte
packets a 24 ms CIF (a logical frame of 24 * 68 p = 1632 p bits). The
decoded bytes of a stream, CIF after CIF, are the interleaved packets.
The outer code and interleaver are those of ETSI EN 300 744 clause 4.3.2:
RS(204,188, t = 8) (``ops.rs.rs_decode_packets`` states its decoding
rule) and the I = 12, M = 17 convolutional interleaver, whose receiver
holds 1122 bytes a stream from one call to the next
(``ops.deinterleave``). Packets are aligned to the stream's first CIF,
where the interleaver starts from zeros: no sync search, and no DVB
randomiser (DAB's energy dispersal takes its place, upstream).

The frames of this chain may be longer than the DLL's 9216 bits (544
kbit/s: 13 056); its exports keep that cap.
"""

from __future__ import annotations

import torch

from ..ops import counts, deinterleave as deint_ops, rs as rs_ops
from ..runtime import calllog
from ..runtime.placement import on_device_bytes, want_kernels
from .dab import decode_frames, depuncture_words, protection_profile

#: kbit/s of one 204-byte packet a 24 ms CIF
PACKET_KBPS = 68
PACKET = rs_ops.P_N
PAYLOAD = rs_ops.P_K
#: the packets a fresh stream puts out before its first sent one
FILL_PACKETS = deint_ops.DELAY // PACKET


def packets_per_cif(bitrate_kbps: int) -> int:
    """The whole 204-byte packets a CIF carries at ``bitrate_kbps``."""
    if bitrate_kbps <= 0 or bitrate_kbps % PACKET_KBPS:
        raise ValueError(f"a T-DMB stream runs at a multiple of "
                         f"{PACKET_KBPS} kbit/s, got {bitrate_kbps}")
    return bitrate_kbps // PACKET_KBPS


def decode_ts_streams(received, bitrate_kbps: int, protection=("A", 3),
                      state=None, device=None,
                      use_kernels: bool | None = None):
    """Decode S transport streams over T CIFs.

    ``received``: uint8 (or any integer type, whose low byte counts)
    [S, T, kept], a tensor or a host array: the MSC's punctured soft
    bytes of each stream's T logical frames, kept = the profile's
    transmitted bits (``protection``: an EEP ``(profile, level)`` or a
    ``puncture.Profile`` covering 24 * ``bitrate_kbps`` bits).
    ``state``: the uint8[S, 1122] deinterleaver FIFOs that the previous
    call on these streams returned, or None for fresh streams (FIFOs of
    zeros, the transmitter's too: the first 11 packets out are then zero
    codewords, 188 zero bytes, with count 0 on a clean channel). Output
    packet m is input packet m - 11; two calls that carry the state give
    byte for byte what one call gives.

    Returns (packets uint8[S, T*p, 188], errors int32[S, T*p]: corrected
    bytes, -1 where uncorrectable and the packet's bytes as received,
    state uint8[S, 1122]) on the symbols' device. A host array goes to
    the card unless ``device`` names another. ``use_kernels=None`` takes
    kernels J, A, B, K and I on a card and the plain path on the CPU.

    The call is the span ``tdmb`` of ``runtime.calllog``, with its stages
    ``ingest``, ``depuncture``, ``viterbi``, ``deinterleave`` (counters
    ``streams``, ``carry_bytes``: the FIFOs' bytes read from the previous
    call, 0 when fresh) and ``rs`` (``codewords``; ``corrected`` and
    ``failed``, the packets with a count above 0 and of -1, set once the
    ``tdmb`` span has closed, so that the wait for them is not the
    stage's), each with its ``launches``.
    """
    with calllog.span("tdmb"):
        p = packets_per_cif(bitrate_kbps)
        prof = protection_profile(protection, bitrate_kbps)
        rec = on_device_bytes(received, device)
        kept = prof.transmitted_bits
        if rec.dim() != 3 or rec.shape[2] != kept:
            raise ValueError(f"received must be [S, T, {kept}] for "
                             f"{prof.name}, got {list(rec.shape)}")
        S, T = rec.shape[0], rec.shape[1]
        if state is not None and (
                not isinstance(state, torch.Tensor)
                or tuple(state.shape) != (S, deint_ops.CARRY_BYTES)):
            raise ValueError(f"state must be the uint8[{S}, "
                             f"{deint_ops.CARRY_BYTES}] a previous call "
                             f"returned, got {state!r:.80}")
        kernels = want_kernels(use_kernels, rec.device)
        words = depuncture_words(rec.reshape(S * T, kept), prof, kernels)
        with counts.stage("viterbi"):
            frames = decode_frames(words, prof.data_bits, kernels,
                                   packed="bt")
        stream = frames.reshape(S, T * p * PACKET)
        with counts.stage("deinterleave") as sp:
            if state is not None:
                state = state.to(rec.device, torch.uint8)
            fn = deint_ops.deinterleave if kernels \
                else deint_ops.deinterleave_plain
            cws, carry = fn(stream, state)
            if sp:
                sp.count(streams=S, carry_bytes=0 if state is None
                         else state.numel())
        with counts.stage("rs") as rs_span:
            fn = rs_ops.rs_decode_packets if kernels \
                else rs_ops.rs_decode_packets_plain
            errors, data = fn(cws.reshape(S * T * p, PACKET))
            if rs_span:
                rs_span.count(codewords=errors.numel())
                tally = torch.stack([(errors > 0).sum(), (errors < 0).sum()])
    if rs_span:
        corrected, failed = tally.tolist()
        rs_span.count(corrected=corrected, failed=failed)
    return (data.reshape(S, T * p, PAYLOAD), errors.reshape(S, T * p),
            carry)
