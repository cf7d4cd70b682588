"""``viterbi_tpu_torch.api.deconvolve_batch(framebits, int32[B, W])`` on a
resident batch: a tensor already on the device, rows of the pool's
``resident`` symbols, decoded where they lie; the bytes come back as a
host array. A return code other than 0 is the call's failure (a program
that takes no tensor returns 1 at once, from its fault guard, and must
not pass for a fast one). The answers are ``deconvolve_batch``'s, from
the host copy."""

from __future__ import annotations

from dabbench.entries.deconvolve_batch import (  # noqa: F401
    compare, control, expect)


def program(sut, pool, call, state):
    ret, out = sut.api.deconvolve_batch(pool.framebits,
                                        pool.resident[call.start:call.stop])
    if ret != 0:
        raise RuntimeError(f"deconvolve_batch returned {ret} on a resident "
                           "batch")
    return ret, out
