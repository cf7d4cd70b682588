"""One call per bitrate of the signal's service mix (role
``superframes``), over ``ensembles_per_event`` ensembles times
``superframes_per_subchannel`` superframes of each subchannel of that
bitrate; ``pool_events`` distinct events, taken in turn."""

from __future__ import annotations

from dabbench.gen.traffic import SUPERFRAME_FRAMES, Call, services, \
    superframe_pools


def build(signal, traffic, gen, device):
    per = traffic["ensembles_per_event"] * \
        traffic["superframes_per_subchannel"]
    n_ev = traffic["pool_events"]
    batch = {k: per * n for k, n in services(signal)}
    pools = superframe_pools({k: n_ev * b for k, b in batch.items()},
                             signal, gen, device)

    def events(k):
        slot = k % n_ev
        return [Call("superframes", f"sf{kb}", slot * b, (slot + 1) * b,
                     bits=b * SUPERFRAME_FRAMES * 24 * kb,
                     frames=b * SUPERFRAME_FRAMES, superframes=b)
                for kb, b in batch.items()]
    return pools, events
