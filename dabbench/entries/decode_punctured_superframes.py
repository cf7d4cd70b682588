"""``viterbi_tpu_torch.models.dab.decode_audio_superframes`` with
``protection`` on a call's punctured int32[B, 5, kept] symbols (host
arrays, as the MSC carries them): the DAB+ chain with its depuncture
stage; audio and RS error counts read back to the host. The answers are
those of the chain on the depunctured symbols (the pool's ``symbols``)."""

from __future__ import annotations

from dabbench.entries.decode_audio_superframes import (  # noqa: F401
    compare, control, expect)


def program(sut, pool, call, state):
    dab = sut.module("viterbi_tpu_torch.models.dab")
    audio, errors = dab.decode_audio_superframes(
        pool.received[call.start:call.stop], pool.kbps, device=sut.device,
        protection=pool.protection)
    return audio.cpu().numpy(), errors.cpu().numpy()
