"""``bitrate_groups`` on a channel of the traffic's own: the traffic
file's ``channel`` parameters (such as a lower ``ebn0_db``) laid over the
configuration's signal, everything else as ``bitrate_groups`` makes
it."""

from __future__ import annotations

from dabbench.gen.events import bitrate_groups


def build(signal, traffic, gen, device):
    return bitrate_groups.build(dict(signal, **traffic["channel"]), traffic,
                                gen, device)
