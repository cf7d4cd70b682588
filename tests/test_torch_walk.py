"""Kernel B's algorithm on the CPU: the walk in segments with a checked
guess (``segments_model``, the schedule of ``csrc/tb_walk.cu`` in plain
torch: every lane but the first guesses state 0) against the serial plain
walk ``tb_walk_plain`` and, through the bytes, against the JAX package's
``chainback_regs_pallas`` in interpret mode; the segment layout, the table
that picks the segments by batch, and the byte plan that the kernel's
epilogue computes arithmetically. The kernel itself runs only on the card
(``tests/test_torch_kernels.py``). Tolerance zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from viterbi_tpu.ops import acs_pallas
from viterbi_tpu.ops import traceback as jax_tb
from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops import traceback as tb

S = 8      # the segments of most cases: K runs over 1, 2, S-1, S, S+1, 129
KS = (1, 2, S - 1, S, S + 1, 129)
B = 5


def _framebits_for(K, ckpt):
    """A byte-aligned frame size whose trellis has K checkpoints."""
    for fb in range(8, 8 * 1024, 8):
        if -(-(fb + C.TAIL_BITS) // ckpt) == K:
            return fb
    raise AssertionError((K, ckpt))


def segments_model(regs, ckpt, gap, anchor=None, anchor_k=None, segments=8):
    """Kernel B's schedule in plain torch: the walk in
    ``segment_layout(K, segments)`` segments, the first entered at the
    anchor and every other from state 0, then re-walked from the newer
    neighbour's exit state, as far as the walk it replaces differs, until
    every entry agrees. Same arguments as ``tb_walk_plain``; returns (rs,
    the rounds of re-walks, the number of (segment, frame) re-walks)."""
    K, _, B = regs.shape
    lanes, L = tb.segment_layout(K, segments)
    a = (torch.zeros(B, dtype=torch.int64) if anchor is None
         else anchor.to(torch.int64))
    ak = (torch.full((B,), K - 1, dtype=torch.int64) if anchor_k is None
          else anchor_k.to(torch.int64))
    rs = torch.empty((K, B), dtype=torch.int32)

    def run(hi, lo, state, store, again=False):
        """Checkpoints hi..lo from ``state`` for the frames of ``store``.
        ``again``: a frame stops where it leaves a checkpoint for the
        state its stored walk left for. Returns (state below lo, frames
        that walked to the end)."""
        live = store
        for k in range(hi, lo - 1, -1):
            shift = gap if k == K - 1 else ckpt
            state = torch.where(ak == k, a, state)
            r = regs[k].gather(0, state[None, :])[0]
            state = ((r >> shift) & 63).to(torch.int64)
            before = rs[k].clone()
            rs[k] = torch.where(live, r, rs[k])
            if again:
                live = live & (((before >> shift) & 63) != state)
        return state, live

    every = torch.ones(B, dtype=torch.bool)
    spans = [(K - 1 - s * L, max(K - (s + 1) * L, 0)) for s in range(lanes)]
    entries = [a] + [torch.zeros_like(a) for _ in spans[1:]]
    exits = [run(hi, lo, entry, every)[0]
             for (hi, lo), entry in zip(spans, entries)]
    rounds = rewalks = 0
    while True:
        prev = [entries[0]] + exits[:-1]
        wrong = [p != e for p, e in zip(prev, entries)]
        if not any(bool(w.any()) for w in wrong):
            return rs, rounds, rewalks
        rounds += 1
        for s, (hi, lo) in enumerate(spans):
            if bool(wrong[s].any()):
                rewalks += int(wrong[s].sum())
                entries[s] = torch.where(wrong[s], prev[s], entries[s])
                left, unmerged = run(hi, lo, entries[s], wrong[s], again=True)
                exits[s] = torch.where(unmerged, left, exits[s])


def _registers(kind, K, ckpt, seed=0):
    """(regs int32[K, 64, B], gap): random bit patterns, whose walks never
    merge, or kernel A's plain version on noisy frames."""
    rng = np.random.default_rng(seed + K + ckpt)
    if kind == "random":
        regs = rng.integers(-2**31, 2**31, (K, 64, B)).astype(np.int32)
        return torch.from_numpy(regs), int(rng.integers(1, ckpt + 1))
    fb = _framebits_for(K, ckpt)
    _, syms = channel.make_frames(B, fb, seed=seed + K)
    regs, _ = acs_cuda.forward_regs_plain(
        torch.from_numpy(syms.astype(np.int32)), fb + C.TAIL_BITS, ckpt=ckpt)
    assert regs.shape[0] == K
    return regs, fb + C.TAIL_BITS - (K - 1) * ckpt


def _anchors(K, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 64, B).astype(np.int32)),
            torch.from_numpy(rng.integers(0, K, B).astype(np.int32)))


@pytest.mark.parametrize("kind", ["random", "forward"])
@pytest.mark.parametrize("ckpt", [14, 24])
@pytest.mark.parametrize("K", KS)
def test_segmented_walk_equals_serial_walk(K, ckpt, kind):
    regs, gap = _registers(kind, K, ckpt)
    anc, anck = _anchors(K, K)
    for a, ak in ((None, None), (anc, None), (anc, anck), (None, anck)):
        want = tb.tb_walk_plain(regs, ckpt, gap, a, ak)
        for segments in (1, 2, S, 32):
            got, rounds, rewalks = segments_model(regs, ckpt, gap, a, ak,
                                                  segments=segments)
            assert torch.equal(got, want), segments
            lanes, _ = tb.segment_layout(K, segments)
            assert rounds <= max(lanes - 1, 0)
            assert (rewalks == 0) == (rounds == 0)


def test_survivors_merge_so_one_round_settles_noisy_frames():
    """On noisy frames nearly every segment entered from state 0 walks
    again, once, and stops where it meets the first walk: its exit state
    stood, so no second round follows."""
    regs, gap = _registers("forward", 129, 24)
    got, rounds, rewalks = segments_model(regs, 24, gap, segments=S)
    assert torch.equal(got, tb.tb_walk_plain(regs, 24, gap))
    assert rounds == 1 and (S - 1) * B // 2 < rewalks <= (S - 1) * B


def test_random_registers_restore_the_serial_order():
    """Walks over random registers do not merge within a segment: the
    rounds run on until the serial order is restored, and the result is
    still the serial walk's."""
    regs, gap = _registers("random", 129, 24)
    got, rounds, _ = segments_model(regs, 24, gap, segments=32)
    assert torch.equal(got, tb.tb_walk_plain(regs, 24, gap))
    assert rounds > 3


@settings(max_examples=60, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), K=st.integers(1, 14),
       batch=st.integers(1, 4), segments=st.integers(1, 32),
       ckpt=st.sampled_from([2, 14, 24, 26]),
       spread=st.sampled_from([1, 2, 5, 64]), anchored=st.booleans(),
       interior=st.booleans())
def test_segmented_walk_equals_serial_walk_for_any_registers(
        seed, K, batch, segments, ckpt, spread, anchored, interior):
    """Any registers: ``spread`` limits the states a step can leave for, so
    walks merge early (1), late or never (64)."""
    rng = np.random.default_rng(seed)
    gap = int(rng.integers(1, ckpt + 1))
    regs = rng.integers(-2**31, 2**31, (K, 64, batch)).astype(np.int64)
    nxt = rng.integers(0, spread, (K, 64, batch))
    shift = np.full((K, 1, 1), ckpt)
    shift[K - 1] = gap
    regs = (regs & ~(63 << shift)) | (nxt << shift)
    regs = torch.from_numpy(regs.astype(np.int32))
    anc = torch.from_numpy(rng.integers(0, 64, batch).astype(np.int32)) \
        if anchored else None
    anck = torch.from_numpy(rng.integers(0, K, batch).astype(np.int32)) \
        if interior else None
    got, _, _ = segments_model(regs, ckpt, gap, anc, anck,
                               segments=segments)
    assert torch.equal(got, tb.tb_walk_plain(regs, ckpt, gap, anc, anck))


@pytest.mark.parametrize("K", [1, 2, 3, 7, 8, 9, 31, 32, 33, 129, 385])
@pytest.mark.parametrize("segments", [1, 2, 4, 8, 16, 32])
def test_segment_layout_covers_every_checkpoint_once(K, segments):
    lanes, per = tb.segment_layout(K, segments)
    assert 1 <= lanes <= min(segments, K)
    spans = [(K - 1 - s * per, max(K - (s + 1) * per, 0))
             for s in range(lanes)]
    covered = [k for hi, lo in spans for k in range(hi, lo - 1, -1)]
    assert covered == list(range(K - 1, -1, -1))
    assert all(hi >= lo for hi, lo in spans)      # no lane without work
    assert (lanes - 1) * per < K                  # the launcher's check


def test_segment_layout_and_table_reject_and_choose():
    for bad in (0, 33, -1):
        with pytest.raises(ValueError, match="segments"):
            tb.segment_layout(9, bad)
    assert tb.walk_segments(16384, 5) == 5        # the caller's
    chosen = [tb.walk_segments(b) for b in (1, 64, 1024, 4096, 10240, 16384,
                                            32768, 65536)]
    assert chosen == sorted(chosen, reverse=True)     # fewer as B grows
    assert chosen[0] == tb.TB_MAX_SEGMENTS and chosen[-1] == 1
    frames = [f for f, _ in tb.TB_SEGMENTS_BY_BATCH]
    assert frames == sorted(frames, reverse=True) and frames[-1] == 0


def _byte_plan_by_byte(framebits, ckpt, K, nsteps, offset):
    """(k, p) of every output byte as kernel B's epilogue computes them:
    integer arithmetic a byte."""
    ks, ps = [], []
    for i in range(framebits // 8):
        tend = offset + 8 * i + 7
        k = min(tend // ckpt, K - 1)
        wend = (k + 1) * ckpt - 1 if k < K - 1 else nsteps - 1
        ks.append(k)
        ps.append(wend - tend)
    return np.array(ks), np.array(ps)


@pytest.mark.parametrize("framebits,ckpt,offset,tail", [
    (3072, 24, 0, 6), (768, 24, 0, 0), (96, 6, 12, 6), (64, 14, 0, 6),
    (264, 18, 0, 6), (264, 10, 0, 6), (32, 24, 0, 6), (40, 24, 0, 6),
    (8, 24, 0, 6), (9216, 24, 0, 6), (192, 22, 0, 6), (96, 8, 2, 0)])
def test_byte_plan_equals_the_kernels_arithmetic(framebits, ckpt, offset,
                                                 tail):
    nsteps = offset + framebits + tail
    K = -(-nsteps // ckpt)
    k, p = tb._byte_plan(framebits, ckpt, K, nsteps, offset)
    want_k, want_p = _byte_plan_by_byte(framebits, ckpt, K, nsteps, offset)
    assert np.array_equal(k, want_k) and np.array_equal(p, want_p)
    assert p.min() >= 0 and p.max() + 7 <= 31


def test_byte_plan_refuses_periods_over_24():
    with pytest.raises(ValueError, match="ckpt"):
        tb._byte_plan(176, 26, 7, 182, 0)


@pytest.mark.parametrize("framebits,ckpt", [(264, None), (264, 10),
                                            (264, 6), (96, None)])
@pytest.mark.parametrize("segments", [1, 4, 32])
def test_segmented_walk_bytes_match_jax_pallas_walk(framebits, ckpt,
                                                    segments):
    """The JAX package's checkpoint walk (Pallas, interpret mode) on its own
    forward pass's registers, against the segmented model's windows put
    through the byte plan, and against ``tb_walk_bytes`` on the CPU."""
    nsteps = framebits + 6
    _, syms = channel.make_frames(3, framebits, seed=framebits + segments)
    syms = syms.astype(np.int32)
    regs, _ = acs_pallas.forward_regs(jnp.asarray(syms), nsteps, ckpt=ckpt,
                                      interpret=True)
    ck = ckpt or acs_pallas.choose_ckpt(nsteps)
    want = np.asarray(jax_tb.chainback_regs_pallas(regs, framebits, ckpt=ck,
                                                   interpret=True))
    tregs = torch.from_numpy(np.array(regs))
    gap = nsteps - (tregs.shape[0] - 1) * ck
    rs, _, _ = segments_model(tregs, ck, gap, segments=segments)
    assert np.array_equal(
        tb._regs_bytes(rs, framebits, ck, gap).numpy(), want)
    rs_cpu, by_cpu = tb.tb_walk_bytes(tregs, framebits, ck, gap,
                                      segments=segments)
    assert torch.equal(rs_cpu, rs) and np.array_equal(by_cpu.numpy(), want)


@pytest.mark.parametrize("pad", [0, 12])
def test_walk_bytes_on_cpu_is_the_two_plain_versions(pad):
    framebits = 96
    n = framebits + 6
    _, syms = channel.make_frames(4, framebits, seed=pad + 1)
    regs, _ = acs_cuda.forward_regs_plain(
        torch.from_numpy(syms.astype(np.int32)), n, front_pad=pad)
    ck = acs_cuda.choose_ckpt(n + pad)
    gap = n + pad - (regs.shape[0] - 1) * ck
    anc, anck = _anchors(regs.shape[0], pad)
    anc, anck = anc[:4], anck[:4]
    rs, got = tb.tb_walk_bytes(regs, framebits, ck, gap, offset=pad,
                               anchor=anc, anchor_k=anck)
    want_rs = tb.tb_walk_plain(regs, ck, gap, anc, anck)
    assert torch.equal(rs, want_rs)
    assert torch.equal(got, tb._regs_bytes(want_rs, framebits, ck, gap,
                                           offset=pad))
    # the wrapper's forms are the kernel's: a CPU tensor takes the plain walk
    assert torch.equal(tb.tb_walk(regs, ck, gap, anc, anck, segments=4),
                       want_rs)
