"""Hand-written CUDA kernels against their plain torch versions on the
card, bit for bit: the pytest twin of ``chip_smoke.py``'s kernel phase
(kernels A and B of the fused path, C and D of the words path, E to H of
the probes).

Every test here needs a CUDA device and skips without one (through the
``cuda`` fixture). Run them on the card with
``python -m pytest tests/test_torch_kernels.py -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops import traceback as tb
from viterbi_tpu_torch.probes import kablate, kdtype, kilp

pytestmark = pytest.mark.cuda

B = 256
# batches that leave the last warp ragged: a frame is held by several
# lanes that talk to each other, so idle lanes must stay alive
RAGGED = (1, 3, 7, 9, 31, 33, 1000)
# kernels A and C: the form the batch selects, one lane a frame, four
FORMS = (None, 1, acs_cuda.LANES)
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
    for lanes in FORMS:
        before = acs_cuda.forward_regs.launches
        r_k, m_k = acs_cuda.forward_regs(syms, framebits + 6, lanes=lanes,
                                         **kw)
        assert acs_cuda.forward_regs.launches == before + 1
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
    before = tb.tb_walk.launches
    got = tb.tb_walk(regs, 24, gap, anc, anck)
    assert tb.tb_walk.launches == before + 1
    assert torch.equal(got, tb.tb_walk_plain(regs, 24, gap, anc, anck))


def test_tb_walk_rejects_out_of_range_anchor(cuda):
    regs = torch.zeros((3, 64, 8), dtype=torch.int32, device=cuda)
    anc = torch.full((8,), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="anchor"):
        tb.tb_walk(regs, 24, 14, anc)


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
        before = acs_cuda.forward.launches
        d_k, m_k = acs_cuda.forward(syms, framebits + 6, init, packed=packed,
                                    lanes=lanes)
        assert acs_cuda.forward.launches == before + 1
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
        before = tb.tb_words.launches
        got = tb.tb_words(words, framebits)
        assert tb.tb_words.launches == before + 1
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
    before = acs_cuda.forward_regs.launches, tb.tb_walk.launches
    audio, errors = dab.decode_audio_superframes(dsyms, kbps)
    assert (acs_cuda.forward_regs.launches, tb.tb_walk.launches) == \
        (before[0] + 1, before[1] + 1)
    p_audio, p_errors = dab.decode_audio_superframes(dsyms, kbps,
                                                     use_kernels=False)
    assert (acs_cuda.forward_regs.launches, tb.tb_walk.launches) == \
        (before[0] + 1, before[1] + 1)
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
        before = kablate.forward_regs_ablated.launches
        r_k, m_k = kablate.forward_regs_ablated(syms, framebits + 6, ablate,
                                                ckpt=24, packed=packed,
                                                lanes=lanes)
        assert kablate.forward_regs_ablated.launches == before + 1
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
    before = kdtype.elementwise.launches
    got = kdtype.elementwise(op, dtype, x, y)
    assert kdtype.elementwise.launches == before + 1
    assert torch.equal(got, kdtype.elementwise_plain(op, dtype, x, y))


@pytest.mark.parametrize("dtype", kdtype.CHAIN_DTYPES)
@pytest.mark.parametrize("top", [204, 256])
def test_chain_kernel_matches_plain(cuda, dtype, top):
    """Lanes below 204 never wrap; up to 255 the narrow types do, and the
    kernel must wrap as the plain version does."""
    x = torch.from_numpy(np.random.default_rng(top).integers(
        0, top, (64, 256)).astype(np.int32)).to(cuda)
    before = kdtype.chain.launches
    got = kdtype.chain(x, 41, dtype)
    assert kdtype.chain.launches == before + 1
    assert torch.equal(got, kdtype.chain_plain(x, 41, dtype))


@pytest.mark.parametrize("mode", kilp.MODES)
@pytest.mark.parametrize("nstreams", kilp.STREAMS)
def test_streams_kernel_matches_plain(cuda, nstreams, mode):
    x = torch.from_numpy(np.random.default_rng(nstreams).integers(
        -999, 999, kilp.SHAPE).astype(np.int32)).to(cuda)
    for c in (3, -2):
        before = kilp.streams.launches
        got = kilp.streams(x, nstreams, mode, 25, c)
        assert kilp.streams.launches == before + 1
        assert torch.equal(got, kilp.streams_plain(x, nstreams, mode, 25, c))
