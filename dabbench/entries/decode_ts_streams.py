"""``viterbi_tpu_torch.models.tdmb.decode_ts_streams`` on a call's
punctured soft bytes uint8[S, T, kept] (host arrays, as the MSC carries
them) at the group's bitrate and protection: the T-DMB chain, the first
call of a round on fresh streams, each later one with the state the call
before returned; packets and RS counts read back to the host, a row a
packet. The answers: the plain reference's Viterbi decode of the round's
depunctured symbols (``answers.Table``), then the benchmark's own
deinterleaver and RS(204,188) decoder (``reference/tdmb.py``) over the
whole round from fresh FIFOs, cut to the call's packets."""

from __future__ import annotations

import numpy as np
import torch

from dabbench import checks
from dabbench.reference import tdmb as ref_tdmb


def program(sut, pool, call, state):
    tdmb = sut.module("viterbi_tpu_torch.models.tdmb")
    rx = pool.received[call.start:call.stop].reshape(call.streams,
                                                     call.cifs, -1)
    carry = state.pop(pool.name, None) if call.part else None
    packets, errors, carry = tdmb.decode_ts_streams(
        rx, pool.kbps, protection=pool.protection, state=carry,
        device=sut.device)
    if call.part + 1 < call.parts:
        state[pool.name] = carry
    return (packets.reshape(-1, ref_tdmb.K).cpu().numpy(),
            errors.reshape(-1).cpu().numpy())


def _round(ref, pool, call):
    """(packets uint8[S, round's packets, 188], counts int32[S, ...]) of
    the call's round, decoded once and kept on the table."""
    cache = ref.__dict__.setdefault("_ts_rounds", {})
    key = (pool.name, call.round_start)
    if key not in cache:
        S = call.streams
        rows = call.parts * S * call.cifs
        frames = ref.frames[pool.name][call.round_start:
                                       call.round_start + rows]
        stream = frames.reshape(call.parts, S, call.cifs, -1) \
            .transpose(1, 0, 2, 3).reshape(S, -1)
        cws, _ = ref_tdmb.deinterleave(
            torch.from_numpy(np.ascontiguousarray(stream)).to(ref.device))
        count, data = ref_tdmb.rs_decode(cws.reshape(-1, ref_tdmb.N))
        cache[key] = (data.reshape(S, -1, ref_tdmb.K).cpu().numpy(),
                      count.reshape(S, -1).to(torch.int32).cpu().numpy())
    return cache[key]


def expect(ref, pool, call):
    data, count = _round(ref, pool, call)
    per = data.shape[1] // call.parts
    part = slice(call.part * per, (call.part + 1) * per)
    return (data[:, part].reshape(-1, ref_tdmb.K).copy(),
            count[:, part].reshape(-1).copy())


def control(ref, pool, call, state):
    return expect(ref, pool, call)


def compare(got, want) -> dict:
    return {"bytes_wrong": checks.bytes_wrong(got[0], want[0]),
            "codes_wrong": checks.bytes_wrong(got[1], want[1])}
