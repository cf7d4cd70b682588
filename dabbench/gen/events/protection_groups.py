"""One call per (bitrate, protection) group of the signal's ``services``
(role ``superframes``), over ``ensembles_per_event`` ensembles times
``superframes_per_subchannel`` superframes of each subchannel of the
group; ``pool_events`` distinct events, taken in turn.

The subchannels share one channel, as those of an ensemble do: every
symbol sent, whatever its subchannel's code rate, at the signal's
``esn0_db`` (``channel.make_superframes`` with the code rate 1/1, so
that its Eb/N0 is the Es/N0). A pool holds what the program reads, the
kept symbols as the MSC carries them (``received``, int32[rows, 5,
kept]), and as ``symbols`` the reference's depuncture of them
(``reference/depuncture.py``), which the plain reference and the
metric readers read."""

from __future__ import annotations

import numpy as np
import torch

from dabbench.gen import channel
from dabbench.gen.traffic import SUPERFRAME_FRAMES, Call, Pool, _bad_rows
from dabbench.reference.depuncture import depuncture


class PuncturedPool(Pool):
    """A ``Pool`` that also holds the program's input: ``received``
    int32[rows, 5, kept] and the group's ``protection`` (profile,
    level)."""

    def __init__(self, name, kbps, framebits, symbols, received,
                 protection):
        super().__init__(name, kbps, framebits, symbols)
        self.received, self.protection = received, protection


def groups(signal):
    """(pool name, kbps, profile, level, subchannels) of each service
    group, in the signal's order."""
    return [(f"sf{s['kbps']}_{s['level']}{s['profile']}", int(s["kbps"]),
             s["profile"], int(s["level"]), int(s["subchannels"]))
            for s in signal["services"]]


def punctured_pool(name, kbps, profile, level, n, signal, gen, bad,
                   device) -> PuncturedPool:
    """``n`` superframes of one group, made on ``device``."""
    sig = dict(signal, protection={"profile": profile, "level": level},
               code_rate=[1, 1], ebn0_db=signal["esn0_db"])
    _, syms = channel.make_superframes(n, kbps, sig, gen, bad, device)
    mask = channel.eep_mask(kbps, level, profile)
    keep = torch.from_numpy(np.nonzero(mask)[0]).to(device)
    received = syms[..., keep]
    del syms
    pool = PuncturedPool(name, kbps, 24 * kbps,
                         depuncture(received, mask).cpu().numpy(),
                         received=received.cpu().numpy(),
                         protection=(profile, level))
    del received
    return pool


def build(signal, traffic, gen, device):
    per = traffic["ensembles_per_event"] * \
        traffic["superframes_per_subchannel"]
    n_ev = traffic["pool_events"]
    gs = groups(signal)
    batch = {name: per * subs for name, _, _, _, subs in gs}
    bad = _bad_rows({name: n_ev * b for name, b in batch.items()}, signal,
                    gen, device)
    pools = {name: punctured_pool(name, kbps, profile, level,
                                  n_ev * batch[name], signal, gen,
                                  bad[name], device)
             for name, kbps, profile, level, _ in gs}

    def events(k):
        slot = k % n_ev
        return [Call("superframes", name, slot * b, (slot + 1) * b,
                     bits=b * SUPERFRAME_FRAMES * 24 * pools[name].kbps,
                     frames=b * SUPERFRAME_FRAMES, superframes=b)
                for name, b in batch.items()]
    return pools, events
