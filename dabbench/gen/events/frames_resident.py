"""``frames``' batches kept on the device as well: one batched call (role
``frames``) of ``frames_per_event`` frames of the signal's
``framebits``, ``pool_events`` distinct batches in turn. The pool keeps
the symbols where they were made (``resident``, an int32 tensor on the
device), which the program reads, and their host copy (``symbols``),
which the plain reference reads. The same seed gives the same frames as
``frames``."""

from __future__ import annotations

from dabbench.gen import channel
from dabbench.gen.traffic import Call, Pool


class ResidentPool(Pool):
    """A ``Pool`` that also holds its symbols on the device."""

    def __init__(self, name, kbps, framebits, symbols, resident):
        super().__init__(name, kbps, framebits, symbols)
        self.resident = resident


def build(signal, traffic, gen, device):
    per, n_ev = traffic["frames_per_event"], traffic["pool_events"]
    fb = int(signal["framebits"])
    _, syms = channel.make_frames(n_ev * per, fb, signal, gen, device)
    pool = ResidentPool(f"fr{fb}", None, fb, syms.cpu().numpy(),
                        resident=syms)

    def events(k):
        slot = k % n_ev
        return [Call("frames", pool.name, slot * per, (slot + 1) * per,
                     bits=per * pool.framebits, frames=per)]
    return {pool.name: pool}, events
