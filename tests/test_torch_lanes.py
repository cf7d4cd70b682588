"""The lane schedule of kernels A and C on the CPU: the Python mirrors
(``ops/acs_cuda.py``) of the ``constexpr`` helpers in ``csrc/trellis.cuh``
that spread one frame over several lanes of a warp, the lane-masked
branch metrics, the deferred register shift, and a model of the whole
lane walk (steps, exchanges, decision words) held against the plain
versions of both kernels. Tolerance zero everywhere: integer arithmetic.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch.ops import acs as acs_ops
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops.acs_cuda import (lane_of, pattern, polarity_word,
                                            slot_of, state_of)

CSRC = Path(acs_cuda.__file__).resolve().parent.parent / "csrc"
LANE_COUNTS = (1, 2, 4)
P = acs_cuda.PHASES


def test_header_constants_match_the_mirrors():
    text = (CSRC / "trellis.cuh").read_text()
    const = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("kLanes") == acs_cuda.LANES
    assert const("kPhases") == acs_cuda.PHASES
    assert const("kStates") == C.NUM_STATES
    for threads in (acs_cuda.ACS_THREADS, acs_cuda.WORDS_THREADS):
        assert threads % 32 == 0 and threads <= const("kMaxThreads")
    # the header asserts the same schedule for the same lane counts
    assert "static_assert(schedule_ok(1) && schedule_ok(2) && " \
           "schedule_ok(4)" in text


@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("phase", range(P + 1))
def test_every_state_has_one_lane_and_slot(lanes, phase):
    per = C.NUM_STATES // lanes
    seen = set()
    for s in range(C.NUM_STATES):
        l, i = lane_of(lanes, phase, s), slot_of(lanes, phase, s)
        assert 0 <= l < lanes and 0 <= i < per
        assert state_of(lanes, phase, l, i) == s
        seen.add((l, i))
    assert len(seen) == C.NUM_STATES
    for l in range(lanes):
        for i in range(per):
            s = state_of(lanes, phase, l, i)
            assert (lane_of(lanes, phase, s), slot_of(lanes, phase, s)) \
                == (l, i)


@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("phase", range(P + 1))
def test_butterfly_partners_share_a_lane(lanes, phase):
    """b and b + 32 lie in one lane, half a lane's slots apart, and (below
    the last phase) so do the two states the butterfly writes."""
    half = C.NUM_STATES // lanes // 2
    for b in range(32):
        assert lane_of(lanes, phase, b) == lane_of(lanes, phase, b + 32)
        assert slot_of(lanes, phase, b + 32) \
            == slot_of(lanes, phase, b) + half
        if phase < P:
            for u in (0, 1):
                assert lane_of(lanes, phase + 1, 2 * b + u) \
                    == lane_of(lanes, phase, b)


@pytest.mark.parametrize("lanes", LANE_COUNTS)
def test_six_steps_are_the_identity(lanes):
    """Follow every (lane, slot) through two runs of three steps with an
    exchange after each: the layout is phase 0's again, and the lane that
    ends up with a state is the one phase 0 names."""
    assert 6 % P == 0
    # where[s] = (lane, slot) of the value that is state s's right now
    for start in range(C.NUM_STATES):
        s, phase = start, 0
        for _ in range(6):
            lane = lane_of(lanes, phase, s)
            s = (2 * s + 1) % C.NUM_STATES     # one of the two successors
            phase += 1
            assert lane_of(lanes, phase, s) == lane    # no traffic in a step
            if phase == P:
                phase = 0                              # the exchange
        assert phase == 0
        assert state_of(lanes, 0, lane_of(lanes, 0, s),
                        slot_of(lanes, 0, s)) == s


def test_pattern_is_linear_and_matches_the_polarity_table():
    pol = np.asarray(C.branch_polarity_table())                 # [4, 32]
    for b in range(32):
        q = pattern(b)
        assert [q >> 2 & 1, q >> 1 & 1, q & 1, q >> 2 & 1] \
            == [int(pol[j, b] != 0) for j in range(4)]
        for x in range(32):
            assert pattern(b ^ x) == pattern(b) ^ pattern(x)
            assert polarity_word(b ^ x) == polarity_word(b) ^ polarity_word(x)


@pytest.mark.parametrize("lanes,phase,lane", [
    (L, p, l) for L in LANE_COUNTS for p in range(P) for l in range(L)])
def test_lane_masked_branch_metrics(lanes, phase, lane):
    """A lane XORs the polarity of its own bits of b into the symbols and
    indexes the eight metrics by the bits its slot holds: for every one of
    its butterflies that is the plain branch metric."""
    rng = np.random.default_rng(100 * lanes + 10 * phase + lane)
    s4 = rng.integers(0, 256, (257, 4), dtype=np.int64)
    words = torch.from_numpy(s4[:, 0] | s4[:, 1] << 8 | s4[:, 2] << 16
                             | s4[:, 3] << 24)
    want = acs_ops.branch_metrics(torch.from_numpy(s4))           # [B, 32]
    m8 = acs_cuda.eight_branch_metrics(words,
                                       polarity_word(lane << phase))
    assert m8.shape == (257, 8) and m8.dtype == torch.int32
    half = C.NUM_STATES // lanes // 2
    seen = set()
    for j in range(half):
        b_rest = state_of(lanes, phase, 0, j)       # the lane's bits clear
        b = state_of(lanes, phase, lane, j)
        assert b < 32 and b == b_rest | lane << phase
        assert torch.equal(m8[:, pattern(b_rest)], want[:, b])
        seen.add(b)
    assert len(seen) == half


def test_unmasked_eight_metrics_cover_all_butterflies():
    rng = np.random.default_rng(8)
    s4 = rng.integers(0, 256, (64, 4), dtype=np.int64)
    words = torch.from_numpy(s4[:, 0] | s4[:, 1] << 8 | s4[:, 2] << 16
                             | s4[:, 3] << 24)
    want = acs_ops.branch_metrics(torch.from_numpy(s4))
    m8 = acs_cuda.eight_branch_metrics(words)
    for b in range(32):
        assert torch.equal(m8[:, pattern(b)], want[:, b])


@pytest.mark.parametrize("n", range(1, 7))
def test_deferred_shift_equals_n_register_steps(n):
    """n select-only steps, then (Q << n) | (s & mask), against n steps of
    the plain version's register update: registers with their high bits
    set, so the truncation to 32 bits is part of the comparison."""
    rng = np.random.default_rng(n)
    regs = torch.from_numpy(rng.integers(-2**31, 2**31, (33, 64),
                                         dtype=np.int64).astype(np.int32))
    regs[0] = torch.arange(64, dtype=torch.int32)                # the seeds
    regs[1] = -1
    stepped = selected = regs
    for _ in range(n):
        dec = torch.from_numpy(rng.integers(0, 2, (33, 64)).astype(bool))
        stepped = acs_cuda.register_step(stepped, dec)
        selected = acs_cuda.register_select(selected, dec)
    assert stepped.dtype == torch.int32
    assert torch.equal(acs_cuda.register_shift_in(selected, n), stepped)


def _exchange(vals, lanes, phase):
    """Every state from its (lane, slot) at ``phase`` to phase 0's."""
    per = C.NUM_STATES // lanes
    out = [[None] * per for _ in range(lanes)]
    for l in range(lanes):
        for i in range(per):
            s = state_of(lanes, phase, l, i)
            out[lane_of(lanes, 0, s)][slot_of(lanes, 0, s)] = vals[l][i]
    return out


def _lane_step(M, Q, words, lanes, phase, odd):
    """One step of every lane as the kernels make it: returns the new
    metrics, the selected registers and the two decision words, built the
    way kernel C builds them (inverted sign bits shifted in from the top
    state down, one more shift between two runs, the word inverted,
    masked to the bits lane 0 owns and shifted by the lane's own bits)."""
    per = C.NUM_STATES // lanes
    half = per // 2
    newM = [[None] * per for _ in range(lanes)]
    newQ = [[None] * per for _ in range(lanes)]
    owned = 0
    for i in range(per):
        n = state_of(lanes, phase + 1, 0, i)
        if n < 32:
            owned |= 1 << n
    word = [torch.zeros_like(words), torch.zeros_like(words)]
    for l in range(lanes):
        m8 = acs_cuda.eight_branch_metrics(
            words, polarity_word(l << phase)).to(torch.int64)
        for k, (lo, hi) in enumerate(((0, half // 2), (half // 2, half))):
            w = torch.zeros_like(words)
            for j in range(hi - 1, lo - 1, -1):
                b = state_of(lanes, phase, 0, j)
                e = slot_of(lanes, phase + 1, 2 * b)
                o = slot_of(lanes, phase + 1, 2 * b + 1)
                m = m8[:, pattern(b)]
                cm = 63 - m
                sat = lambda x: torch.clamp_max(x, 255)
                p0e, p1e = sat(M[l][j] + m), sat(M[l][j + half] + cm)
                p0o, p1o = sat(M[l][j] + cm), sat(M[l][j + half] + m)
                newM[l][e] = torch.minimum(p0e, p1e)
                newM[l][o] = torch.minimum(p0o, p1o)
                newQ[l][e] = torch.where(p1e <= p0e, Q[l][j + half], Q[l][j])
                newQ[l][o] = torch.where(p1o <= p0o, Q[l][j + half], Q[l][j])
                if j < hi - 1:
                    w = w << (2 * (state_of(lanes, phase, 0, j + 1) - b) - 2)
                w = (w << 1) | (p0o < p1o)
                w = (w << 1) | (p0e < p1e)
            word[k] = word[k] | ((~w & owned) << (l << (phase + 1)))
    if odd:
        sub = (newM[0][0] > 150) * 63        # state 0: slot 0 of lane 0
        newM = [[torch.clamp_min(v - sub, 0) for v in lane] for lane in newM]
    return newM, newQ, word


@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("nsteps", [6, 12, 16, 20])
def test_lane_walk_matches_the_plain_versions(lanes, nsteps):
    """The whole walk of one checkpoint window as the kernels make it
    (runs of three steps with an exchange, what is left in single steps
    with an exchange each, the deferred shift a window) gives kernel A's
    checkpoint, kernel C's decision words and the final metrics of the
    plain versions."""
    rng = np.random.default_rng(nsteps + lanes)
    B = 37
    raw = rng.integers(0, 256, (B, 4 * nsteps), dtype=np.int32)
    words = torch.from_numpy(acs_cuda.pack_symbols_host(raw))      # [B, T]
    init = torch.from_numpy(rng.integers(0, 256, (B, 64)).astype(np.int32))
    want_regs, want_met = acs_cuda.forward_regs_plain(
        words, nsteps, init, ckpt=nsteps, packed="bt")
    want_dec, want_met_c = acs_cuda.forward_plain(words, nsteps, init,
                                                  packed="bt")
    per = C.NUM_STATES // lanes
    u32 = lambda w: w.to(torch.int64) & 0xFFFFFFFF
    M = [[init[:, state_of(lanes, 0, l, i)].to(torch.int64)
          for i in range(per)] for l in range(lanes)]
    Q = [[torch.full((B,), state_of(lanes, 0, l, i), dtype=torch.int32)
          for i in range(per)] for l in range(lanes)]
    t, dec = 0, []

    def steps(count, phase0):
        nonlocal M, Q, t
        for k in range(count):
            M, Q, word = _lane_step(M, Q, u32(words[:, t]), lanes,
                                    phase0 + k, t % 2 == 1)
            dec.append(torch.stack(word, dim=-1))
            t += 1
        M, Q = _exchange(M, lanes, phase0 + count), \
            _exchange(Q, lanes, phase0 + count)

    window = nsteps                      # one checkpoint: ckpt = nsteps
    while t < nsteps:
        start = t
        while t + 6 <= start + window:
            steps(3, 0)
            steps(3, 0)
            Q = [[(q << 6) | (state_of(lanes, 0, l, i) & 63)
                  for i, q in enumerate(lane)] for l, lane in enumerate(Q)]
        while t < start + window:
            steps(1, 0)
            steps(1, 0)
            Q = [[(q << 2) | (state_of(lanes, 0, l, i) & 3)
                  for i, q in enumerate(lane)] for l, lane in enumerate(Q)]
    got_met = torch.empty((B, 64), dtype=torch.int64)
    got_regs = torch.empty((64, B), dtype=torch.int32)
    for l in range(lanes):
        for i in range(per):
            got_met[:, state_of(lanes, 0, l, i)] = M[l][i]
            got_regs[state_of(lanes, 0, l, i)] = Q[l][i]
    assert torch.equal(got_met.to(torch.int32), want_met)
    assert torch.equal(want_met, want_met_c)
    assert torch.equal(got_regs, want_regs[-1])
    got_dec = torch.stack(dec)                                   # [T, B, 2]
    assert torch.equal(got_dec & 0xFFFFFFFF, u32(want_dec))


def test_the_batch_selects_the_form():
    """Four lanes a frame below the kernel's threshold, one from there on;
    a named form is taken as it is, any other number refused."""
    for threshold in (acs_cuda.REGS_ONE_LANE_FRAMES,
                      acs_cuda.WORDS_ONE_LANE_FRAMES):
        assert threshold > 1
        assert acs_cuda._lanes(1, threshold, None) == acs_cuda.LANES
        assert acs_cuda._lanes(threshold - 1, threshold, None) \
            == acs_cuda.LANES
        assert acs_cuda._lanes(threshold, threshold, None) == 1
        assert acs_cuda._lanes(1, threshold, 1) == 1
        assert acs_cuda._lanes(10 * threshold, threshold, acs_cuda.LANES) \
            == acs_cuda.LANES
    for lanes in (0, 2, 3, 8):
        with pytest.raises(ValueError, match="lanes"):
            acs_cuda._lanes(64, 1024, lanes)


@pytest.mark.parametrize("lanes", [None, 1, acs_cuda.LANES])
def test_a_named_form_gives_the_plain_results_on_the_cpu(lanes):
    """On a CPU tensor the wrappers run the plain versions whatever form
    is named."""
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(rng.integers(0, 256, (5, 4 * 38), dtype=np.int32))
    r, m = acs_cuda.forward_regs(raw, 38, lanes=lanes)
    r_p, m_p = acs_cuda.forward_regs_plain(raw, 38)
    assert torch.equal(r, r_p) and torch.equal(m, m_p)
    d, m = acs_cuda.forward(raw, 38, lanes=lanes)
    d_p, m_p = acs_cuda.forward_plain(raw, 38)
    assert torch.equal(d, d_p) and torch.equal(m, m_p)
