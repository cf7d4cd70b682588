"""Hand-written CUDA kernels against their plain torch versions on the
card, bit for bit: the pytest twin of ``chip_smoke.py``'s kernel phase
(kernels A and B of the fused path, C and D of the words path, E to H of
the probes, I of RS).

Every test here needs a CUDA device and skips without one (through the
``cuda`` fixture). Run them on the card with
``python -m pytest tests/test_torch_kernels.py -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from torch_rs_traps import TRAPS, trap_word

from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.ops import _build
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops import rs as rs_ops
from viterbi_tpu_torch.ops import traceback as tb
from viterbi_tpu_torch.probes import (_common, kablate, kdtype, kilp, rsform,
                                      rsphases)

pytestmark = pytest.mark.cuda

B = 256
# batches that leave the last warp ragged: a frame is held by several
# lanes that talk to each other, so idle lanes must stay alive
RAGGED = (1, 3, 7, 9, 31, 33, 1000)
# kernels A and C: the form the batch selects, one lane a frame, four
FORMS = (None, 1, acs_cuda.LANES)
# kernel A also in its warp-wide form
REGS_FORMS = (*FORMS, acs_cuda.WARP_LANES)
# the warp-wide form at the DAB frame sizes and two more on the byte grid,
# at the batches around it and around its threshold
WARP_FRAMEBITS = (768, 1152, 1536, 2304, 3072, 96, 4608)
WARP_BATCHES = (1, 2, 5, 31, 33, 40, 256, acs_cuda.REGS_WARP_FRAMES - 1,
                acs_cuda.REGS_WARP_FRAMES + 1)
REGS_SHAPES = [
    (192, False, 0, True), (768, "bt", 12, False), (1536, True, 0, True),
    (3072, "bt", 0, True), (3072, False, 6, False), (9216, "bt", 0, False),
    (64, False, 0, True), (64, "bt", 0, False), (32, "bt", 0, True),
    (32, False, 0, False)]
WORDS_SHAPES = [
    (192, False, True), (768, "bt", False), (1536, True, True),
    (3072, "bt", True), (3072, False, False), (9216, True, False),
    (64, "bt", True), (96, False, False), (2328, True, True)]


@pytest.fixture
def cuda():
    """The card, or a skip: the one skip helper for kernel tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc "
                    "for sm_90a and run only on the card)")
    return torch.device("cuda", 0)


def _symbols(rng, framebits, packed, dev, batch=B):
    n = framebits + 6
    raw = rng.integers(0, 256, (batch, 4 * n), dtype=np.int32)
    if packed:
        words = acs_cuda.pack_symbols_host(raw)
        raw = words if packed == "bt" else np.ascontiguousarray(words.T)
    return torch.from_numpy(raw).to(dev)


def _hold_regs(dev, framebits, packed, front_pad, with_init, batch=B,
               ckpt=None):
    """Kernel A against its plain version on one shape, bit for bit."""
    rng = np.random.default_rng(framebits + front_pad + batch)
    syms = _symbols(rng, framebits, packed, dev, batch)
    init = (torch.from_numpy(rng.integers(0, 256, (batch, 64))
                             .astype(np.int32)).to(dev)
            if with_init else None)
    kw = dict(initial_metrics=init, packed=packed, front_pad=front_pad,
              ckpt=ckpt)
    r_p, m_p = acs_cuda.forward_regs_plain(syms, framebits + 6, **kw)
    # the form the batch selects, then each form by name
    for lanes in REGS_FORMS:
        before = _build.ACS_REGS.launches
        r_k, m_k = acs_cuda.forward_regs(syms, framebits + 6, lanes=lanes,
                                         **kw)
        assert _build.ACS_REGS.launches == before + 1
        assert torch.equal(r_k, r_p) and torch.equal(m_k, m_p), lanes


@pytest.mark.parametrize("framebits,packed,front_pad,with_init", REGS_SHAPES)
def test_acs_regs_kernel_matches_plain(cuda, framebits, packed, front_pad,
                                       with_init):
    _hold_regs(cuda, framebits, packed, front_pad, with_init)


@pytest.mark.parametrize("batch", RAGGED)
@pytest.mark.parametrize("framebits,packed,front_pad,with_init", REGS_SHAPES)
def test_acs_regs_kernel_ragged_batch(cuda, framebits, packed, front_pad,
                                      with_init, batch):
    _hold_regs(cuda, framebits, packed, front_pad, with_init, batch)


@pytest.mark.parametrize("ckpt", [24, 14, 2])
@pytest.mark.parametrize("front_pad", [2, 4, 8, 10, 14, 20])
def test_acs_regs_kernel_reset_inside_a_window(cuda, front_pad, ckpt):
    """The reset re-seeds each lane with the states it holds at phase 0,
    so the six-step window it falls into must end at the reset."""
    for packed in ("bt", False):
        _hold_regs(cuda, 96, packed, front_pad, True, 33, ckpt)


@pytest.mark.parametrize("ckpt", range(2, 28, 2))
def test_acs_regs_kernel_every_checkpoint_period(cuda, ckpt):
    _hold_regs(cuda, 90, "bt", 0, True, 65, ckpt)


def _hold_every_form(syms, nsteps, **kw):
    """Kernel A in every form, each by name and as the batch selects,
    against its plain version and the other forms, bit for bit; the
    batch's choice is the form it launched."""
    r_p, m_p = acs_cuda.forward_regs_plain(syms, nsteps, **kw)
    B = r_p.shape[2]
    want = acs_cuda._lanes(B, acs_cuda.REGS_ONE_LANE_FRAMES, None,
                           acs_cuda.REGS_WARP_FRAMES)
    assert want == (acs_cuda.WARP_LANES if B < acs_cuda.REGS_WARP_FRAMES
                    else acs_cuda.LANES)
    for lanes in REGS_FORMS:
        before = dict(_build.ACS_REGS.tally)
        r_k, m_k = acs_cuda.forward_regs(syms, nsteps, lanes=lanes, **kw)
        took = [k for k, n in _build.ACS_REGS.tally.items()
                if n != before[k]]
        assert took == [lanes or want], (lanes, took)
        assert torch.equal(r_k, r_p) and torch.equal(m_k, m_p), lanes
    return r_p


@pytest.mark.parametrize("batch", WARP_BATCHES)
@pytest.mark.parametrize("framebits", WARP_FRAMEBITS)
def test_acs_regs_warp_form_matches_every_form(cuda, framebits, batch):
    """The decode path's layout: ckpt 24, so a partial last checkpoint at
    every DAB size; entry metrics; unpacked int32 symbols (the live
    calls') and frame-major packed words."""
    rng = np.random.default_rng(framebits * 1000 + batch)
    n = framebits + 6
    for packed in (False, "bt"):
        syms = _symbols(rng, framebits, packed, cuda, batch)
        init = torch.from_numpy(rng.integers(0, 256, (batch, 64))
                                .astype(np.int32)).to(cuda)
        regs = _hold_every_form(syms, n, initial_metrics=init, ckpt=24,
                                packed=packed)
        assert regs.shape[0] == -(-n // 24)


@pytest.mark.parametrize("batch", [1, 5, 33])
def test_acs_regs_warp_form_on_the_session_and_tail_biting_shapes(cuda,
                                                                  batch):
    """As tail-biting runs kernel A (no tail, the warm-up's metrics,
    choose_ckpt's period), as streaming and the session run it (a window
    of frame-major words that starts inside the rows, entry metrics, a
    partial last checkpoint) and with a front pad, whose reset falls
    inside a six-step window."""
    rng = np.random.default_rng(batch)
    raw = rng.integers(0, 256, (batch, 4 * 800), dtype=np.int32)
    init = torch.from_numpy(rng.integers(0, 256, (batch, 64))
                            .astype(np.int32)).to(cuda)
    syms = torch.from_numpy(raw).to(cuda)
    _hold_every_form(syms, 768, initial_metrics=init,
                     ckpt=acs_cuda.choose_ckpt(768))
    words = torch.from_numpy(acs_cuda.pack_symbols_host(raw)).to(cuda)
    for start, steps in ((0, 480), (7, 490), (314, 486)):
        _hold_every_form(words[:, start:], steps, initial_metrics=init,
                         ckpt=24, packed="bt")
    for pad in (4, 14, 22):
        _hold_every_form(words, 774, initial_metrics=init, ckpt=24,
                         packed="bt", front_pad=pad)
        _hold_every_form(syms, 774, ckpt=18, front_pad=pad)


@pytest.mark.parametrize("anchored,interior", [(False, False), (True, False),
                                               (True, True)])
def test_tb_walk_kernel_matches_plain(cuda, anchored, interior):
    rng = np.random.default_rng(3)
    syms = _symbols(rng, 768, "bt", cuda)
    regs, _ = acs_cuda.forward_regs(syms, 774, ckpt=24, packed="bt")
    K = regs.shape[0]
    gap = 774 - (K - 1) * 24
    anc = (torch.from_numpy(rng.integers(0, 64, B).astype(np.int32))
           .to(cuda) if anchored else None)
    anck = (torch.from_numpy(rng.integers(0, K, B).astype(np.int32))
            .to(cuda) if interior else None)
    before = _build.TB_WALK.launches
    got = tb.tb_walk(regs, 24, gap, anc, anck)
    assert _build.TB_WALK.launches == before + 1
    assert torch.equal(got, tb.tb_walk_plain(regs, 24, gap, anc, anck))


def test_tb_walk_rejects_out_of_range_anchor(cuda):
    """The range check reads the caller's host tensor, so that no call
    waits for the card; an anchor that lies on the card is masked to six
    bits by the kernel, which never reads outside the checkpoints."""
    rng = np.random.default_rng(4)
    regs = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 64, 8))
                            .astype(np.int32)).to(cuda)
    anc = torch.full((8,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="anchor"):
        tb.tb_walk(regs, 24, 14, anc)
    with pytest.raises(ValueError, match="anchor"):
        tb.tb_walk(regs, 24, 14, None, torch.full((8,), 3, dtype=torch.int32))
    got = tb.tb_walk(regs, 24, 14, anc.to(cuda) + 5)
    assert torch.equal(got, tb.tb_walk_plain(
        regs, 24, 14, torch.full((8,), 5, dtype=torch.int32)))


# kernel B's forms: the batch's choice, then segments a frame by name
WALK_FORMS = (None, 1, 2, 4, 8, 16, 32)


def _hold_walk(regs, ckpt, gap, anc, anck):
    for a, ak in ((None, None), (anc, None), (anc, anck)):
        want = tb.tb_walk_plain(regs, ckpt, gap, a, ak)
        for segments in WALK_FORMS:
            before = _build.TB_WALK.launches
            got = tb.tb_walk(regs, ckpt, gap, a, ak, segments=segments)
            assert _build.TB_WALK.launches == before + 1
            assert torch.equal(got, want), segments


@pytest.mark.parametrize("batch", [1, 31, 33, B, 1000])
@pytest.mark.parametrize("K,ckpt,gap", [(1, 24, 6), (2, 14, 14), (7, 24, 24),
                                        (8, 24, 1), (9, 14, 2), (129, 24, 6)])
def test_tb_walk_kernel_forms_on_random_registers(cuda, K, ckpt, gap, batch):
    """Walks over random registers never merge: every segment is walked
    again until the serial order is restored."""
    rng = np.random.default_rng(K + batch)
    regs = torch.from_numpy(rng.integers(-2**31, 2**31, (K, 64, batch))
                            .astype(np.int32)).to(cuda)
    anc = torch.from_numpy(rng.integers(0, 64, batch).astype(np.int32))
    anck = torch.from_numpy(rng.integers(0, K, batch).astype(np.int32))
    _hold_walk(regs, ckpt, gap, anc.to(cuda), anck.to(cuda))
    _hold_walk(regs, ckpt, gap, anc, anck)   # host anchors


@pytest.mark.parametrize("batch", [1, 33, B])
@pytest.mark.parametrize("framebits,pad,ckpt,tail", [
    (3072, 0, 24, 6), (768, 0, 24, 0), (96, 12, None, 6), (64, 0, None, 6),
    (192, 0, 14, 6), (32, 0, 24, 6)])
def test_tb_walk_kernel_forms_and_bytes_on_kernel_a_registers(
        cuda, framebits, pad, ckpt, tail, batch):
    rng = np.random.default_rng(framebits + batch)
    n = framebits + tail
    raw = rng.integers(0, 256, (batch, 4 * n), dtype=np.int32)
    regs, _ = acs_cuda.forward_regs(torch.from_numpy(raw).to(cuda), n,
                                    ckpt=ckpt, front_pad=pad)
    ck = ckpt or acs_cuda.choose_ckpt(n + pad)
    K = regs.shape[0]
    gap = n + pad - (K - 1) * ck
    anc = torch.from_numpy(rng.integers(0, 64, batch).astype(np.int32))
    anck = torch.from_numpy(rng.integers(0, K, batch).astype(np.int32))
    _hold_walk(regs, ck, gap, anc.to(cuda), anck.to(cuda))
    for a, ak in ((None, None), (anc.to(cuda), anck.to(cuda))):
        want_rs = tb.tb_walk_plain(regs, ck, gap, a, ak)
        want = tb._regs_bytes(want_rs, framebits, ck, gap, tail, pad)
        for segments in WALK_FORMS:
            before = _build.TB_WALK.launches
            rs, got = tb.tb_walk_bytes(regs, framebits, ck, gap, tail, pad,
                                       a, ak, segments=segments)
            assert _build.TB_WALK.launches == before + 1
            assert got.dtype == torch.uint8
            assert torch.equal(rs, want_rs) and torch.equal(got, want), \
                segments


def test_kernels_launch_on_the_callers_stream_and_refused_launches_raise(
        cuda):
    rng = np.random.default_rng(8)
    regs = torch.from_numpy(rng.integers(-2**31, 2**31, (40, 64, 65))
                            .astype(np.int32)).to(cuda)
    want = tb.tb_walk_plain(regs, 24, 6)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = tb.tb_walk(regs, 24, 6)
    side.synchronize()
    assert torch.equal(got, want)
    a = torch.zeros(64, dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="kdtype_op launch failed"):
        _build.KDTYPE_OP.launch(cuda, 9, 0, a.data_ptr(), a.data_ptr(),
                                a.data_ptr(), 64)
    with pytest.raises(RuntimeError, match="tb_walk launch failed"):
        _build.TB_WALK.launch(cuda, regs.data_ptr(), None, None, 65, 40, 24,
                              6, got.data_ptr(), None, 0, 0, 0, 33)


def test_wrap_last6_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (B, 4 * 96), dtype=np.int32)
    regs, _ = acs_cuda.forward_regs(torch.from_numpy(raw).to(cuda), 96,
                                    ckpt=24)
    anc = torch.from_numpy(rng.integers(0, 64, B).astype(np.int32))
    got = tb.chainback_regs_cuda(regs, 96, ckpt=24, tail=0,
                                 anchor=anc.to(cuda), wrap_last6=True)
    want = tb.chainback_regs_cuda(regs.cpu(), 96, ckpt=24, tail=0,
                                  anchor=anc, wrap_last6=True)
    assert torch.equal(got.cpu(), want)


def _hold_words(dev, framebits, packed, with_init, batch=B):
    """Kernel C against its plain version on one shape, bit for bit."""
    rng = np.random.default_rng(framebits + batch)
    syms = _symbols(rng, framebits, packed, dev, batch)
    init = (torch.from_numpy(rng.integers(0, 256, (batch, 64))
                             .astype(np.int32)).to(dev)
            if with_init else None)
    d_p, m_p = acs_cuda.forward_plain(syms, framebits + 6, init,
                                      packed=packed)
    for lanes in FORMS:
        before = _build.ACS_WORDS.launches
        d_k, m_k = acs_cuda.forward(syms, framebits + 6, init, packed=packed,
                                    lanes=lanes)
        assert _build.ACS_WORDS.launches == before + 1
        assert torch.equal(d_k, d_p) and torch.equal(m_k, m_p), lanes


@pytest.mark.parametrize("framebits,packed,with_init", WORDS_SHAPES)
def test_acs_words_kernel_matches_plain(cuda, framebits, packed, with_init):
    _hold_words(cuda, framebits, packed, with_init)


@pytest.mark.parametrize("batch", RAGGED)
@pytest.mark.parametrize("framebits,packed,with_init", WORDS_SHAPES)
def test_acs_words_kernel_ragged_batch(cuda, framebits, packed, with_init,
                                       batch):
    _hold_words(cuda, framebits, packed, with_init, batch)


@pytest.mark.parametrize("framebits", [24, 48, 768, 2328, 9216])
def test_tb_words_kernel_matches_plain(cuda, framebits):
    rng = np.random.default_rng(framebits + 1)
    dec, _ = acs_cuda.forward(_symbols(rng, framebits, "bt", cuda),
                              framebits + 6, packed="bt")
    noise = torch.from_numpy(rng.integers(
        -2**31, 2**31, (framebits + 9, B, 2), dtype=np.int64)
        .astype(np.int32)).to(cuda)
    for words in (dec, noise):
        before = _build.TB_WORDS.launches
        got = tb.tb_words(words, framebits)
        assert _build.TB_WORDS.launches == before + 1
        assert torch.equal(got, tb.tb_words_plain(words, framebits))


def test_tb_words_rejects_off_window_framebits(cuda):
    dec = torch.zeros((70, 8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="24"):
        tb.tb_words(dec, 64)


@pytest.mark.parametrize("framebits", [64, 3072])
def test_words_decode_on_card_matches_golden(cuda, framebits):
    _, syms = channel.make_frames(4, framebits, seed=framebits + 2)
    expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
    dec, _ = acs_cuda.forward(torch.from_numpy(syms.astype(np.int32))
                              .to(cuda), framebits + 6)
    for got in (tb.chainback_blocked(dec, framebits, block=32),
                tb.chainback_scan(dec, framebits)):
        assert got.is_cuda and np.array_equal(got.cpu().numpy(), expect)
    if framebits % 24 == 0:
        got = tb.chainback_words_cuda(dec, framebits)
        assert np.array_equal(got.cpu().numpy(), expect)


@pytest.mark.parametrize("framebits", [32, 64, 3072])
def test_decode_on_card_matches_golden(cuda, framebits):
    _, syms = channel.make_frames(4, framebits, seed=framebits)
    expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
    packed = torch.from_numpy(acs_cuda.pack_symbols_host(syms)).to(cuda)
    got = acs_cuda.decode(packed, framebits, packed="bt")
    assert got.is_cuda and np.array_equal(got.cpu().numpy(), expect)


@pytest.mark.parametrize("kbps", [32, 128])
def test_superframe_chain_on_card_matches_plain_only_call(cuda, kbps):
    """Kernels A and B on the chain's unpacked symbols (decode()'s
    checkpoint period, no front pad) against the same call through plain
    versions only, on the card. Tolerance zero."""
    from viterbi_tpu_torch.models import dab
    _, syms = channel.make_superframes(6, kbps, seed=kbps, ebn0_db=3.0,
                                       uncorrectable=1)
    dsyms = torch.from_numpy(syms).to(cuda)

    def launches():
        return (_build.ACS_REGS.launches, _build.TB_WALK.launches,
                _build.RS_SUPERFRAMES.launches)

    before = launches()
    audio, errors = dab.decode_audio_superframes(dsyms, kbps)
    assert launches() == tuple(n + 1 for n in before)
    p_audio, p_errors = dab.decode_audio_superframes(dsyms, kbps,
                                                     use_kernels=False)
    assert launches() == tuple(n + 1 for n in before)
    assert torch.equal(audio, p_audio) and torch.equal(errors, p_errors)
    assert (errors == -1).any() and (errors >= 0).any()


def test_punctured_frames_on_card_match_plain_only_call(cuda):
    from viterbi_tpu_torch.models import dab
    from viterbi_tpu_torch.models import puncture as P
    _, syms = channel.make_frames(B, 768, seed=2, ebn0_db=6.0)
    rec = torch.from_numpy(P.puncture(
        syms, P.eep_profile(32, 2, "B").mask()).astype(np.int32)).to(cuda)
    got = dab.decode_punctured_frames(rec, 32, 2, "B")
    assert torch.equal(got, dab.decode_punctured_frames(rec, 32, 2, "B",
                                                        use_kernels=False))


@pytest.mark.parametrize("framebits,packed", [(3072, "bt"), (768, True),
                                              (64, "bt"), (32, "bt")])
@pytest.mark.parametrize("name,ablate", kablate.VARIANTS)
@pytest.mark.parametrize("batch", [B, 33])
def test_ablation_kernel_matches_plain(cuda, name, ablate, framebits,
                                       packed, batch):
    rng = np.random.default_rng(framebits)
    syms = _symbols(rng, framebits, packed, cuda, batch)
    r_p, m_p = kablate.forward_regs_ablated_plain(syms, framebits + 6,
                                                  ablate, ckpt=24,
                                                  packed=packed)
    for lanes in FORMS:
        before = _build.KABLATE.launches
        r_k, m_k = kablate.forward_regs_ablated(syms, framebits + 6, ablate,
                                                ckpt=24, packed=packed,
                                                lanes=lanes)
        assert _build.KABLATE.launches == before + 1
        assert torch.equal(r_k, r_p) and torch.equal(m_k, m_p), lanes
        if not ablate:      # nothing left out: kernel A itself, bit for bit
            r_a, m_a = acs_cuda.forward_regs(syms, framebits + 6, ckpt=24,
                                             packed=packed, lanes=lanes)
            assert torch.equal(r_k, r_a) and torch.equal(m_k, m_a), lanes


@pytest.mark.parametrize("dtype,op", [(d, o) for d in kdtype.OP_DTYPES
                                      for o in kdtype.OPS]
                         + list(kdtype.PACKED_OPS))
def test_narrow_op_kernel_matches_plain(cuda, dtype, op):
    lane = kdtype._lane_dtype(dtype)
    bits = kdtype._BITS[lane]
    lo = -(1 << (bits - 1)) if lane.startswith("i") else 0
    rng = np.random.default_rng(bits + len(op))
    x, y = (torch.from_numpy(rng.integers(lo, lo + (1 << bits),
                                          kdtype.OP_SHAPE)
                             .astype(np.int32)).to(cuda) for _ in range(2))
    before = _build.KDTYPE_OP.launches
    got = kdtype.elementwise(op, dtype, x, y)
    assert _build.KDTYPE_OP.launches == before + 1
    assert torch.equal(got, kdtype.elementwise_plain(op, dtype, x, y))


@pytest.mark.parametrize("dtype,op", [(d, o) for d in kdtype.OP_DTYPES
                                      for o in kdtype.OPS]
                         + list(kdtype.PACKED_OPS))
def test_narrow_op_kernel_tails_and_alignment(cuda, dtype, op):
    """Kernel F at lane counts around one thread's 16 bytes, with and
    without a tail, on operands that start at a 16-byte boundary and one
    element past it."""
    lane = kdtype._lane_dtype(dtype)
    bits = kdtype._BITS[lane]
    lo = -(1 << (bits - 1)) if lane.startswith("i") else 0
    per = kdtype._PACKED[dtype][1] if dtype in kdtype._PACKED else 1
    codes = kdtype._op_codes(op, dtype)
    rng = np.random.default_rng(bits + len(op))
    for count in kdtype.TAIL_COUNTS:
        for skip in (0, 1):
            x, y = (torch.from_numpy(rng.integers(
                lo, lo + (1 << bits), (count + skip) * per)
                .astype(np.int32)).to(cuda) for _ in range(2))
            a = kdtype._to_storage(x, dtype)[skip:]
            b = kdtype._to_storage(y, dtype)[skip:]
            out = torch.empty(count + skip, dtype=a.dtype,
                              device=cuda)[skip:]
            kdtype._launch_op(codes, a, b, out)
            got = kdtype._from_storage(out, dtype, (count * per,))
            assert torch.equal(got, kdtype.elementwise_plain(
                op, dtype, x[skip * per:], y[skip * per:])), (count, skip)


@pytest.mark.parametrize("dtype", kdtype.CHAIN_DTYPES)
@pytest.mark.parametrize("top", [204, 256])
def test_chain_kernel_matches_plain(cuda, dtype, top):
    """Lanes below 204 never wrap; up to 255 the narrow types do, and the
    kernel must wrap as the plain version does."""
    x = torch.from_numpy(np.random.default_rng(top).integers(
        0, top, (64, 256)).astype(np.int32)).to(cuda)
    before = _build.KDTYPE_CHAIN.launches
    got = kdtype.chain(x, 41, dtype)
    assert _build.KDTYPE_CHAIN.launches == before + 1
    assert torch.equal(got, kdtype.chain_plain(x, 41, dtype))


@pytest.mark.parametrize("mode", kilp.MODES)
@pytest.mark.parametrize("nstreams", kilp.STREAMS)
def test_streams_kernel_matches_plain(cuda, nstreams, mode):
    x = torch.from_numpy(np.random.default_rng(nstreams).integers(
        -999, 999, kilp.SHAPE).astype(np.int32)).to(cuda)
    for c in (3, -2):
        before = _build.KILP_STREAMS.launches
        got = kilp.streams(x, nstreams, mode, 25, c)
        assert _build.KILP_STREAMS.launches == before + 1
        assert torch.equal(got, kilp.streams_plain(x, nstreams, mode, 25, c))


# --- kernel I: the RS(120,110) decoder ---------------------------------------

def _hold_rs(blocks, want=None):
    """Kernel I on ``blocks`` (any view) against its plain version on the
    same tensor: one launch, bit for bit."""
    before = _build.RS_DECODE.launches
    got = rs_ops.rs_decode_blocks(blocks)
    assert _build.RS_DECODE.launches == before + 1
    want = want or rs_ops.rs_decode_blocks_plain(blocks)
    for g, w in zip(got, want, strict=True):
        assert g.is_cuda and g.dtype == torch.int32
        assert torch.equal(g, w)
    return got


def _rs_mix(mix, codewords, seed=5):
    """``probes.rsform``'s mix: clean codewords with planted errors."""
    rng = np.random.default_rng(seed)
    clean = np.tile(golden.rs_encode_many(rng.integers(
        0, 256, (256, C.RS_KK), dtype=np.uint8)).astype(np.int32),
        (-(-codewords // 256), 1))[:codewords]
    return rsform.corrupt_mix(rng, clean, *rsform.MIXES[mix])


@pytest.mark.parametrize("mix", list(rsform.MIXES))
def test_rs_kernel_matches_plain_on_the_mixes(cuda, mix):
    cws, nerr = _rs_mix(mix, rsform.CODEWORDS)
    count, corrected = _hold_rs(torch.from_numpy(cws).to(cuda))
    count, corrected = count.cpu().numpy(), corrected.cpu().numpy()
    fixed = nerr <= 5
    assert np.array_equal(count[fixed], nerr[fixed])
    # nine errors: -1, or a miscorrection into another codeword, as golden
    for i in np.nonzero(~fixed)[0]:
        g_count, g_corr = golden.rs_decode_codeword(cws[i])
        assert count[i] == g_count and np.array_equal(corrected[i], g_corr)


@pytest.mark.parametrize("batch", [1, 31, 33, 4097])
def test_rs_kernel_ragged_batches(cuda, batch):
    """Batches that leave a block's last warps idle and, at 4097, more
    codewords than warps in flight on some cards' grids."""
    cws, _ = _rs_mix("all dirty", batch, seed=batch)
    _hold_rs(torch.from_numpy(cws).to(cuda))
    _hold_rs(torch.from_numpy(cws.astype(np.uint8)).to(cuda))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("rs_dims", [1, 16, 48])
def test_rs_kernel_reads_the_export_and_chain_views(cuda, dtype, rs_dims):
    """The export's deinterleaved view [rs_dims, 120] (strides 1 and
    rs_dims) and the chain's [B, rs_dims, 120] view of B superframes, read
    in place, with no copy before the launch."""
    B = 7
    cws, _ = _rs_mix("64 uncorrectable", B * rs_dims, seed=rs_dims)
    sf = torch.from_numpy(cws.reshape(B, rs_dims, C.RS_N).transpose(0, 2, 1)
                          .reshape(B, -1).copy()).to(dtype).to(cuda)
    want = rs_ops.rs_decode_blocks_plain(torch.from_numpy(cws).to(cuda))
    view = sf.reshape(B, C.RS_N, rs_dims).transpose(1, 2)
    assert not view.is_contiguous() or rs_dims == 1
    count, corrected = _hold_rs(view)
    assert torch.equal(count.reshape(-1), want[0])
    assert torch.equal(corrected.reshape(-1, C.RS_N), want[1])
    for b in (0, B - 1):
        blocks = rs_ops.deinterleave(sf[b], rs_dims)
        rows = slice(b * rs_dims, (b + 1) * rs_dims)
        _hold_rs(blocks, (want[0][rows], want[1][rows]))


@pytest.mark.parametrize("trap", list(TRAPS))
def test_rs_kernel_holds_the_reference_traps(cuda, trap):
    word = trap_word(trap)
    blocks = torch.from_numpy(np.stack([word] * 3).astype(np.int32)).to(cuda)
    count, corrected = _hold_rs(blocks)
    g_count, g_corr = golden.rs_decode_codeword(word)
    assert (count.cpu() == g_count).all()
    assert (corrected.cpu().numpy() == g_corr).all()


def test_rs_kernel_is_one_launch_and_the_superframe_check_follows(cuda):
    """rs_decode_blocks on a card tensor is kernel I, one device launch
    (the plain version takes about 340), and the export's check is one
    launch of its superframes entry; int64 codewords are refused, not
    converted."""
    cws, _ = _rs_mix("clean-dominated", 4096)
    blocks = torch.from_numpy(cws).to(cuda)
    rs_ops.rs_decode_blocks(blocks)
    assert _common.count_launches(
        lambda: rs_ops.rs_decode_blocks(blocks)) <= 1
    before = _build.RS_SUPERFRAMES.launches
    p = blocks[:16].T.reshape(-1).to(torch.uint8).contiguous()
    errors, out, n_ok = rs_ops.rs_check_superframe(p, 16)
    assert _build.RS_SUPERFRAMES.launches == before + 1
    assert _common.count_launches(
        lambda: rs_ops.rs_check_superframe(p, 16)) <= 1
    g_err, g_out = golden.rs_check_superframe(p.cpu().numpy(), 16)
    assert int(errors) == g_err
    if g_err >= 0:
        assert np.array_equal(out.cpu().numpy(), g_out)
    with pytest.raises(TypeError, match="uint8 or int32"):
        rs_ops.rs_decode_blocks(blocks.long())


# --- kernel I's superframes entry -------------------------------------------

def _sf_batch(rs_dims, G, mix="64 uncorrectable", seed=0):
    """G byte-interleaved superframes of rs_dims codewords of a mix."""
    cws, _ = _rs_mix(mix, G * rs_dims, seed=seed)
    return np.ascontiguousarray(cws.reshape(G, rs_dims, C.RS_N)
                                .transpose(0, 2, 1).reshape(G, -1)
                                .astype(np.uint8))


def _hold_sf(sf, rs_dims, zero):
    """Kernel I's superframes entry and the probe's table syndrome form
    against the plain version on the same tensor: one launch each."""
    want = rs_ops.rs_check_superframes_plain(sf, rs_dims,
                                             zero_after_fail=zero)
    for entry, kernel in ((rs_ops.rs_check_superframes,
                           _build.RS_SUPERFRAMES),
                          (rsform.rs_check_superframes_table_synd,
                           _build.RS_TABLE_SUPERFRAMES)):
        before = kernel.launches
        got = entry(sf, rs_dims, zero_after_fail=zero)
        assert kernel.launches == before + 1
        for g, w in zip(got, want, strict=True):
            assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w)
    return want


@pytest.mark.parametrize("zero", [True, False])
@pytest.mark.parametrize("G,rs_dims", [
    (G, d) for G in (1, 7) for d in (1, 2, 4, 16, 48, 130)]
    + [(2048, 4), (2048, 16)])
def test_rs_superframes_kernel_matches_plain(cuda, G, rs_dims, zero):
    """Every rs_dims the chain and the export meet (and 130, more
    codewords than a block stages by default), one superframe to
    the chain's 2048, the zero fill on and off; odd rs_dims give rows off
    the 16-byte grid."""
    sf = torch.from_numpy(_sf_batch(rs_dims, G, seed=G + rs_dims)).to(cuda)
    errors, _, n_ok = _hold_sf(sf, rs_dims, zero)
    assert ((errors == -1) == (n_ok < rs_dims)).all()


@pytest.mark.parametrize("offset,pitch", [(0, 8), (1, 0), (8, 24)])
def test_rs_superframes_kernel_reads_rows_where_they_lie(cuda, offset,
                                                         pitch):
    """Rows further apart than their length and views that start off the
    16-byte grid: read in place, no copy before the launch."""
    rs_dims, G = 16, 9
    sfs = _sf_batch(rs_dims, G, seed=offset)
    L = rs_dims * C.RS_N
    base = torch.zeros(G * (L + pitch) + offset + L, dtype=torch.uint8)
    rows = base[offset:offset + G * (L + pitch)].view(G, L + pitch)[:, :L]
    rows.copy_(torch.from_numpy(sfs))
    view = base.to(cuda)[offset:offset + G * (L + pitch)] \
        .view(G, L + pitch)[:, :L]
    assert view.stride() == (L + pitch, 1)
    _hold_sf(view, rs_dims, True)


@pytest.mark.parametrize("trap", list(TRAPS))
def test_rs_superframes_kernel_holds_the_reference_traps(cuda, trap):
    word = trap_word(trap).astype(np.uint8)
    cws = np.stack([word, word, word, word])
    sf = torch.from_numpy(np.ascontiguousarray(cws.T.reshape(1, -1))) \
        .to(cuda)
    errors, out, _ = _hold_sf(sf, 4, False)
    g_err, g_out = golden.rs_check_superframe(sf[0].cpu().numpy(), 4)
    assert int(errors[0]) == g_err
    if g_err >= 0:
        assert np.array_equal(out[0].cpu().numpy(), g_out)


def test_rs_stage_and_export_are_one_launch_each(cuda):
    """The chain's RS stage and the export each launch kernel I once and
    nothing else on the card (the export: a copy each way besides); the
    entry refuses int32 superframes and byte strides, not converts."""
    from viterbi_tpu_torch import api
    from viterbi_tpu_torch.models import dab
    sf = torch.from_numpy(_sf_batch(16, 64)).to(cuda)
    before = _build.RS_SUPERFRAMES.launches
    dab.rs_superframes(sf, 16, True)
    assert _build.RS_SUPERFRAMES.launches == before + 1
    assert _common.count_launches(
        lambda: dab.rs_superframes(sf, 16, True)) == 1
    api.initialize(device=cuda)
    one = sf[3].cpu().numpy()
    before = _build.RS_SUPERFRAMES.launches
    ret = api.rs_check_superframe(one, 0, 16)
    assert _build.RS_SUPERFRAMES.launches == before + 1
    assert ret == golden.rs_check_superframe(one, 16)[0]
    assert _common.count_launches(
        lambda: api.rs_check_superframe(one, 0, 16)) <= 3
    with pytest.raises(TypeError, match="uint8"):
        rs_ops.rs_check_superframes(sf.int(), 16, zero_after_fail=True)
    with pytest.raises(ValueError, match="contiguous"):
        rs_ops.rs_check_superframes(sf.t().contiguous().t(), 16,
                                    zero_after_fail=True)


def test_rs_phases_probe_times_kernel_i_and_matches_plain(cuda):
    """The step probe (kernel I's superframes entry with the card's clock
    at each step) gives the plain version's output and times that add up:
    each step takes time, the span covers the median block."""
    for name, G, rs_dims, frac, max_errs, bad in rsphases.CASES:
        sf = torch.from_numpy(rsphases.superframes(
            np.random.default_rng(G), G, rs_dims, frac, max_errs, bad)) \
            .to(cuda)
        got = rsphases.phases(sf, rs_dims)     # raises on any difference
        assert got["blocks"] * got["per_block"] >= G
        assert all(t >= 0 for t in got["mean_us"]) and got["span_us"] > 0
        assert got["end_p50_us"] <= got["span_us"]
        assert (got["dirty_max"] > 0) == (frac > 0 or bad > 0), name
