"""The one traffic generator: makes, from the seed, the host inputs of
every call of a cell and the schedule of its events.

A traffic file names its ``loop`` (``loops/<loop>.py``), the ``signal``
of the configuration it receives, and the ``event`` it is made of: a
generator of its own, ``gen/events/<event>.py``, with ``build(signal,
traffic, gen, device) -> (pools, events)``, where ``pools`` are the host
inputs and ``events(k)`` the calls of event k. Each call names a role
(``"superframes"``, ``"frames"``, ...); the configuration (or the
traffic file, over it) maps each role to the entry adapter that makes the
call, ``entries/<name>.py``.

Every seed gets the same sizes and arrivals; only the content differs.
One superframe in ``uncorrectable_one_in`` (the signal's) carries nine
byte errors in one codeword. Inputs are made on the device in a few large
calls and handed over as host arrays, contiguous, so that a call's input
is a view and the timed path copies nothing on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import channel

SUPERFRAME_FRAMES = channel.SUPERFRAME_FRAMES


@dataclasses.dataclass
class Pool:
    name: str
    kbps: int | None
    framebits: int
    symbols: np.ndarray            # int32 [rows, 5, W] or [rows, W]

    @property
    def superframes(self) -> bool:
        return self.symbols.ndim == 3

    @property
    def rs_dims(self) -> int:
        return channel.rs_dims_of(self.kbps)


@dataclasses.dataclass(frozen=True)
class Call:
    role: str          # the entry adapter's role in the cell
    pool: str
    start: int         # first row
    stop: int          # one past the last row
    frame: int = -1    # one frame of the row's superframe
    sub: int = -1      # the subchannel
    bits: int = 0      # decoded data bits the call returns
    frames: int = 0    # frames the call decodes (kernel A's work)
    superframes: int = 0   # superframes it RS-checks, rows start on


@dataclasses.dataclass
class Workload:
    loop: str
    period_s: float
    pools: dict
    events: object               # k -> list[Call]
    trace_events: int
    entries: dict = dataclasses.field(default_factory=dict)
    #: role -> (name, entry adapter module)

    def event(self, k: int) -> list[Call]:
        return self.events(k)


def services(signal: dict) -> list[tuple[int, int]]:
    """(kbps, subchannels), highest bitrate first."""
    return sorted(((int(k), int(n)) for k, n in signal["services_kbps"]),
                  reverse=True)


def _bad_rows(rows: dict, signal: dict, gen, device) -> dict:
    """bool masks per pool: the superframes that carry an uncorrectable
    codeword, one in ``uncorrectable_one_in`` of all, placed by the seed."""
    total = sum(rows.values())
    one_in = signal.get("uncorrectable_one_in")
    n_bad = round(total / one_in) if one_in else 0
    flat = torch.zeros(total, dtype=torch.bool, device=device)
    flat[torch.randperm(total, generator=gen, device=device)[:n_bad]] = True
    out, at = {}, 0
    for k, n in rows.items():
        out[k] = flat[at:at + n]
        at += n
    return out


def superframe_pools(rows: dict, signal: dict, gen, device) -> dict:
    """A pool ``sf<kbps>`` of ``rows[kbps]`` superframes for each
    bitrate."""
    bad = _bad_rows(rows, signal, gen, device)
    pools = {}
    for kbps, n in rows.items():
        _, syms = channel.make_superframes(n, kbps, signal, gen, bad[kbps],
                                           device)
        pools[f"sf{kbps}"] = Pool(f"sf{kbps}", kbps, 24 * kbps,
                                  syms.cpu().numpy())
        del syms
    return pools


def frame_pool(n: int, signal: dict, gen, device) -> Pool:
    """A pool ``fr<framebits>`` of ``n`` frames."""
    fb = int(signal["framebits"])
    _, syms = channel.make_frames(n, fb, signal, gen, device)
    pool = Pool(f"fr{fb}", None, fb, syms.cpu().numpy())
    del syms
    return pool


def build(cell, seed: int, device) -> Workload:
    """The cell's workload from the seed, its inputs made on ``device``."""
    traffic = cell.traffic
    signal = cell.config["signals"][traffic["signal"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pools, events = cell.events.build(signal, traffic, gen, device)
    return Workload(loop=traffic["loop"],
                    period_s=traffic.get("period_ms", 0) / 1e3,
                    pools=pools, events=events,
                    trace_events=int(traffic["trace_events"]),
                    entries=cell.entries)
