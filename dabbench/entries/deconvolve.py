"""``viterbi_tpu_torch.api.deconvolve(framebits, int32[W], 0, out)``: one
logical frame of a superframe's row, its bytes written into the caller's
buffer. The frames decoded for a subchannel are kept in the run's
``state`` for its superframe check (``rs_check_superframe``)."""

from __future__ import annotations

import numpy as np

from dabbench import checks


def _keep(state, call, out):
    got = state.setdefault(("frames", call.sub), {})
    if call.frame == 0:
        got.clear()
    got[call.frame] = out


def program(sut, pool, call, state):
    out = np.empty(pool.framebits // 8, np.uint8)
    ret = sut.api.deconvolve(pool.framebits,
                             pool.symbols[call.start, call.frame], 0, out)
    _keep(state, call, out)
    return ret, out


def expect(ref, pool, call):
    return 0, ref.frames[pool.name][call.start, call.frame].copy()


def control(ref, pool, call, state):
    ret, out = expect(ref, pool, call)
    _keep(state, call, out)
    return ret, out


def compare(got, want) -> dict:
    return checks.code_and_bytes(got, want)
