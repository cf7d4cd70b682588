"""``viterbi_tpu_torch.models.dab.decode_audio_superframes`` on a call's
int32[B, 5, W] symbols (host arrays): the DAB+ chain, Viterbi, superframe
assembly and RS; audio and RS error counts read back to the host."""

from __future__ import annotations

import numpy as np

from dabbench import checks


def program(sut, pool, call, state):
    dab = sut.module("viterbi_tpu_torch.models.dab")
    audio, errors = dab.decode_audio_superframes(
        pool.symbols[call.start:call.stop], pool.kbps, device=sut.device)
    return audio.cpu().numpy(), errors.cpu().numpy()


def expect(ref, pool, call):
    errors, audio, _ = ref.checked(pool.name)
    return (audio[call.start:call.stop].copy(),
            errors[call.start:call.stop].astype(np.int32))


def control(ref, pool, call, state):
    return expect(ref, pool, call)


def compare(got, want) -> dict:
    return {"bytes_wrong": checks.bytes_wrong(got[0], want[0]),
            "codes_wrong": checks.bytes_wrong(got[1], want[1])}
