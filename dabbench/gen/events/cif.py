"""One ensemble's common interleaved frame every ``period_ms``: one
single-frame call per subchannel (role ``frame``), and one superframe
check (role ``superframe_check``) for each subchannel whose superframe
completes (subchannel i's superframes start at CIFs i, i + 5, ...);
``pool_superframes`` distinct superframes a subchannel, in turn; with
``ensembles`` (default 1) the ensembles' CIFs take turns, one event
each."""

from __future__ import annotations

from dabbench.gen.traffic import SUPERFRAME_FRAMES, Call, services, \
    superframe_pools


def build(signal, traffic, gen, device):
    subs = [(kb, j) for kb, n in services(signal) for j in range(n)]
    n_sf, n_ens = traffic["pool_superframes"], traffic.get("ensembles", 1)
    counts: dict = {}
    for kb, _ in subs:
        counts[kb] = counts.get(kb, 0) + 1
    pools = superframe_pools(
        {kb: n_ens * n * n_sf for kb, n in counts.items()}, signal, gen,
        device)

    def events(k):
        e, t = k % n_ens, k // n_ens        # ensembles' CIFs in turn
        calls = []
        for i, (kb, j) in enumerate(subs):
            s, f = divmod(t - i, SUPERFRAME_FRAMES)
            row = (e * counts[kb] + j) * n_sf + s % n_sf
            sub = e * len(subs) + i
            calls.append(Call("frame", f"sf{kb}", row, row + 1, frame=f,
                              sub=sub, bits=24 * kb, frames=1))
            if f == SUPERFRAME_FRAMES - 1 and \
                    t - (SUPERFRAME_FRAMES - 1) >= 0:
                calls.append(Call("superframe_check", f"sf{kb}", row,
                                  row + 1, sub=sub, superframes=1))
        return calls
    return pools, events
