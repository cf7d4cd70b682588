"""One batched call (role ``frames``) of ``frames_per_event`` frames of
the signal's ``framebits``; ``pool_events`` distinct batches, in turn."""

from __future__ import annotations

from dabbench.gen.traffic import Call, frame_pool


def build(signal, traffic, gen, device):
    per, n_ev = traffic["frames_per_event"], traffic["pool_events"]
    pool = frame_pool(n_ev * per, signal, gen, device)

    def events(k):
        slot = k % n_ev
        return [Call("frames", pool.name, slot * per, (slot + 1) * per,
                     bits=per * pool.framebits, frames=per)]
    return {pool.name: pool}, events
