"""T-DMB transport streams in DAB stream-mode subchannels: for each
group of the signal's ``services`` (a bitrate of 68 p kbit/s, its EEP
protection and its streams an ensemble), ``ensembles_per_event``
ensembles' streams over a round of ``calls_per_round`` x
``cifs_per_call`` CIFs, one chain call (role ``streams``) a group and a
part of the round; the first part of a round starts the streams fresh,
each later one continues the one before with its state; ``pool_events``
distinct rounds, taken in turn.

Each stream of a round: random 188-byte packets (their first byte the
sync byte 0x47), the benchmark's own RS(204,188) encoder, one packet in
``uncorrectable_one_in`` of all given ``uncorrectable_bytes`` byte errors
after the encoder, the I = 12 interleaver from zeros
(``reference/tdmb.py``), p packets a CIF's logical frame of 1632 p
bits, then the mother code, the group's puncturing and the channel
(``channel.frames_to_symbols``) at the signal's ``esn0_db`` on every sent
symbol. A pool holds what the program reads, the kept soft bytes
(``received``, uint8[rows, kept]), and as ``symbols`` their depunctured
stream (uint8, 127 at punctured positions), which the plain reference
decodes. Rows lie round by round, then part by part, then stream by
stream, then CIF by CIF, so that a call's input is one contiguous block.
"""

# no ``from __future__ import annotations``: a dataclass with string
# annotations looks its module up in sys.modules, where a file loaded by
# its path (``cells.plugin``) is not
import dataclasses

import numpy as np
import torch

from dabbench.gen import channel
from dabbench.gen.traffic import Call, Pool
from dabbench.reference import tdmb as ref_tdmb

#: kbit/s of one 204-byte packet a 24 ms CIF
PACKET_KBPS = 68
SYNC_BYTE = 0x47


@dataclasses.dataclass(frozen=True)
class StreamCall(Call):
    streams: int = 0       # S, the call's streams
    cifs: int = 0          # T, its CIFs a stream
    part: int = 0          # its place in the round; 0 starts fresh
    parts: int = 1         # the calls of a round
    round_start: int = 0   # the round's first row


class StreamPool(Pool):
    """A ``Pool`` that also holds the program's input, ``received``
    uint8[rows, kept], and the group's ``protection`` (profile, level)."""

    def __init__(self, name, kbps, framebits, symbols, received,
                 protection):
        super().__init__(name, kbps, framebits, symbols)
        self.received, self.protection = received, protection


def groups(signal):
    """(pool name, kbps, profile, level, streams an ensemble) of each
    service group."""
    return [(f"ts{s['kbps']}_{s['level']}{s['profile']}", int(s["kbps"]),
             s["profile"], int(s["level"]), int(s["streams"]))
            for s in signal["services"]]


def _packets(n: int, signal: dict, gen, device) -> torch.Tensor:
    """``n`` RS(204,188) codewords of random packets, one in
    ``uncorrectable_one_in`` hit by ``uncorrectable_bytes`` byte errors."""
    msgs = torch.randint(0, 256, (n, ref_tdmb.K), generator=gen,
                         device=device, dtype=torch.uint8)
    msgs[:, 0] = SYNC_BYTE
    cws = ref_tdmb.rs_encode(msgs)
    n_bad = round(n / signal["uncorrectable_one_in"])
    if n_bad:
        rows = torch.randperm(n, generator=gen, device=device)[:n_bad]
        e = int(signal["uncorrectable_bytes"])
        pos = torch.rand((n_bad, ref_tdmb.N), generator=gen,
                         device=device).argsort(dim=1)[:, :e]
        val = torch.randint(1, 256, (n_bad, e), generator=gen,
                            device=device, dtype=torch.uint8)
        hit = cws[rows]
        hit.scatter_(1, pos, hit.gather(1, pos) ^ val)
        cws[rows] = hit
    return cws


def stream_pool(name, kbps, profile, level, streams, rounds, parts, cifs,
                signal, gen, device) -> StreamPool:
    """Every round of one group, made on ``device``."""
    p = kbps // PACKET_KBPS
    fb = 24 * kbps
    per_stream = parts * cifs * p                     # packets a round
    cws = _packets(rounds * streams * per_stream, signal, gen, device)
    sent = ref_tdmb.interleave(cws.reshape(rounds * streams, -1))
    shifts = torch.arange(7, -1, -1, device=device)
    bits = ((sent[..., None].to(torch.int64) >> shifts) & 1) \
        .reshape(rounds, streams, parts, cifs, fb) \
        .transpose(1, 2).reshape(-1, fb)
    del cws, sent
    sig = dict(signal, protection={"profile": profile, "level": level},
               code_rate=[1, 1], ebn0_db=signal["esn0_db"])
    syms = channel.frames_to_symbols(bits, sig, kbps, gen)
    del bits
    keep = torch.from_numpy(np.nonzero(channel.eep_mask(kbps, level,
                                                        profile))[0])
    received = syms[:, keep.to(device)].to(torch.uint8)
    pool = StreamPool(name, kbps, fb, syms.to(torch.uint8).cpu().numpy(),
                      received=received.cpu().numpy(),
                      protection=(profile, level))
    del syms, received
    return pool


def build(signal, traffic, gen, device):
    ens = int(traffic["ensembles_per_event"])
    parts, cifs = int(traffic["calls_per_round"]), int(traffic["cifs_per_call"])
    n_ev = int(traffic["pool_events"])
    gs = groups(signal)
    pools = {name: stream_pool(name, kbps, profile, level, ens * k, n_ev,
                               parts, cifs, signal, gen, device)
             for name, kbps, profile, level, k in gs}

    def events(k):
        slot = k % n_ev
        out = []
        for name, kbps, _, _, per_ens in gs:
            S = ens * per_ens
            rows = S * cifs
            r0 = slot * parts * rows
            for part in range(parts):
                out.append(StreamCall(
                    "streams", name, r0 + part * rows, r0 + (part + 1) * rows,
                    bits=rows * 24 * kbps, frames=rows, streams=S,
                    cifs=cifs, part=part, parts=parts, round_start=r0))
        return out
    return pools, events
