"""``viterbi_tpu_torch.api.deconvolve_batch(framebits, int32[B, W])``:
the batched export on host symbols, through the API's own ingest."""

from __future__ import annotations

from dabbench import checks


def program(sut, pool, call, state):
    return sut.api.deconvolve_batch(pool.framebits,
                                    pool.symbols[call.start:call.stop])


def expect(ref, pool, call):
    return 0, ref.frames[pool.name][call.start:call.stop].copy()


def control(ref, pool, call, state):
    return expect(ref, pool, call)


def compare(got, want) -> dict:
    return checks.code_and_bytes(got, want)
