"""``viterbi_tpu_torch.api.rs_check_superframe(bytes, 0, rs_dims, out)``
on the superframe that this run's ``deconvolve`` calls decoded for the
subchannel, ``out`` filled with ``answers.SENTINEL`` first so that the -1
prefix write shows. The answer it must give is RScheckSuperframe on the
reference's decoded superframe."""

from __future__ import annotations

import numpy as np

from dabbench import checks
from dabbench.answers import SENTINEL, Table
from dabbench.reference.rs import KK


def _superframe(pool, call, state) -> np.ndarray:
    got = state.get(("frames", call.sub), {})
    n = pool.symbols.shape[1]
    if sorted(got) != list(range(n)):
        raise RuntimeError(f"subchannel {call.sub}: frames {sorted(got)} "
                           f"of {n} decoded")
    return np.concatenate([got[f] for f in range(n)])


def program(sut, pool, call, state):
    out = np.full(pool.rs_dims * KK, SENTINEL, np.uint8)
    ret = sut.api.rs_check_superframe(_superframe(pool, call, state), 0,
                                      pool.rs_dims, out)
    return ret, out


def expect(ref, pool, call):
    errors, audio, n_ok = ref.checked(pool.name)
    return Table.export(audio[call.start], int(errors[call.start]),
                        int(n_ok[call.start]), pool.rs_dims)


def control(ref, pool, call, state):
    errors, audio, n_ok = ref.check(_superframe(pool, call, state),
                                    pool.rs_dims)
    return Table.export(audio, errors, n_ok, pool.rs_dims)


def compare(got, want) -> dict:
    return checks.code_and_bytes(got, want)
