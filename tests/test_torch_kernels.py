"""Hand-written CUDA kernels against their plain torch versions on the
card, bit for bit: the pytest twin of ``chip_smoke.py``'s kernel phase
(kernels A and B of the fused path, C and D of the words path).

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

pytestmark = pytest.mark.cuda

B = 256


@pytest.fixture
def cuda():
    """The card, or a skip: the one skip helper for kernel tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc "
                    "for sm_90a and run only on the card)")
    return torch.device("cuda", 0)


def _symbols(rng, framebits, packed, dev):
    n = framebits + 6
    raw = rng.integers(0, 256, (B, 4 * n), dtype=np.int32)
    if packed:
        words = acs_cuda.pack_symbols_host(raw)
        raw = words if packed == "bt" else np.ascontiguousarray(words.T)
    return torch.from_numpy(raw).to(dev)


@pytest.mark.parametrize("framebits,packed,front_pad,with_init", [
    (192, False, 0, True), (768, "bt", 12, False), (1536, True, 0, True),
    (3072, "bt", 0, True), (3072, False, 6, False), (9216, "bt", 0, False),
    (64, False, 0, True), (64, "bt", 0, False), (32, "bt", 0, True),
    (32, False, 0, False)])
def test_acs_regs_kernel_matches_plain(cuda, framebits, packed, front_pad,
                                       with_init):
    rng = np.random.default_rng(framebits + front_pad)
    syms = _symbols(rng, framebits, packed, cuda)
    init = (torch.from_numpy(rng.integers(0, 256, (B, 64))
                             .astype(np.int32)).to(cuda)
            if with_init else None)
    kw = dict(initial_metrics=init, packed=packed, front_pad=front_pad)
    before = acs_cuda.forward_regs.launches
    r_k, m_k = acs_cuda.forward_regs(syms, framebits + 6, **kw)
    assert acs_cuda.forward_regs.launches == before + 1
    r_p, m_p = acs_cuda.forward_regs_plain(syms, framebits + 6, **kw)
    assert torch.equal(r_k, r_p) and torch.equal(m_k, m_p)


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


@pytest.mark.parametrize("framebits,packed,with_init", [
    (192, False, True), (768, "bt", False), (1536, True, True),
    (3072, "bt", True), (3072, False, False), (9216, True, False),
    (64, "bt", True), (96, False, False), (2328, True, True)])
def test_acs_words_kernel_matches_plain(cuda, framebits, packed, with_init):
    rng = np.random.default_rng(framebits)
    syms = _symbols(rng, framebits, packed, cuda)
    init = (torch.from_numpy(rng.integers(0, 256, (B, 64))
                             .astype(np.int32)).to(cuda)
            if with_init else None)
    before = acs_cuda.forward.launches
    d_k, m_k = acs_cuda.forward(syms, framebits + 6, init, packed=packed)
    assert acs_cuda.forward.launches == before + 1
    d_p, m_p = acs_cuda.forward_plain(syms, framebits + 6, init,
                                      packed=packed)
    assert torch.equal(d_k, d_p) and torch.equal(m_k, m_p)


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
