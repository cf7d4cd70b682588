"""The decision-word decode path of the port against the JAX package's:
the decisions forward pass (kernel C's plain version), the decision-word
walk (kernel D's plain version) and the blocked traceback, bit for bit.
The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas.py`` does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viterbi_tpu import golden as jax_golden
from viterbi_tpu.harness import channel
from viterbi_tpu.ops import acs as jax_acs
from viterbi_tpu.ops import acs_pallas
from viterbi_tpu.ops import traceback as jax_tb
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.ops import _build
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops import traceback as tb


def _layout(syms: np.ndarray, packed):
    """Symbols [B, 4T] in the given forward layout."""
    if not packed:
        return syms
    words = acs_pallas.pack_symbols_host(syms)
    return words if packed == "bt" else np.ascontiguousarray(words.T)


def _jax_decisions(syms: np.ndarray, framebits: int) -> np.ndarray:
    d, _ = jax_acs.forward(jnp.asarray(syms.astype(np.int32)),
                           framebits + 6)
    return np.array(d)


@pytest.mark.parametrize("framebits,packed,with_init", [
    (48, False, False), (48, "bt", True), (96, True, False),
    (96, False, True), (120, "bt", False), (120, True, True)])
def test_forward_plain_matches_pallas_forward(framebits, packed, with_init):
    rng = np.random.default_rng(framebits)
    nsteps = framebits + 6
    syms = rng.integers(0, 256, (5, 4 * nsteps), dtype=np.int64) \
        .astype(np.int32)
    init = (rng.integers(0, 256, (5, 64)).astype(np.int32) if with_init
            else None)
    host = _layout(syms, packed)
    d_j, m_j = acs_pallas.forward(
        jnp.asarray(host), nsteps,
        None if init is None else jnp.asarray(init), interpret=True,
        packed=packed)
    d_t, m_t = acs_cuda.forward_plain(
        torch.from_numpy(host), nsteps,
        None if init is None else torch.from_numpy(init), packed=packed)
    assert d_t.dtype == torch.int32 and d_t.shape == (nsteps, 5, 2)
    assert np.array_equal(d_t.numpy().view(np.uint32), np.asarray(d_j))
    assert np.array_equal(m_t.numpy(), np.asarray(m_j))


def test_forward_on_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper runs its plain version and launches
    nothing."""
    syms = np.random.default_rng(3).integers(0, 256, (4, 4 * 54),
                                             dtype=np.int32)
    before = _build.ACS_WORDS.launches
    d, m = acs_cuda.forward(torch.from_numpy(syms), 54)
    d_p, m_p = acs_cuda.forward_plain(torch.from_numpy(syms), 54)
    assert _build.ACS_WORDS.launches == before
    assert torch.equal(d, d_p) and torch.equal(m, m_p)


@pytest.mark.parametrize("bad", [0, 53])
def test_forward_rejects_odd_nsteps(bad):
    syms = torch.zeros((2, 4 * 54), dtype=torch.int32)
    with pytest.raises(ValueError, match="even"):
        acs_cuda.forward(syms, bad)


def test_unpack_symbols_round_trips():
    syms = np.random.default_rng(4).integers(0, 256, (3, 4 * 10),
                                             dtype=np.int32)
    for packed in (False, True, "bt"):
        got = acs_cuda.unpack_symbols(
            torch.from_numpy(_layout(syms, packed)), 10, packed)
        assert np.array_equal(got.numpy(), syms), packed


@pytest.mark.parametrize("framebits,batch", [(48, 3), (2328, 2), (768, 130)])
def test_word_walk_matches_pallas(framebits, batch):
    _, syms = channel.make_frames(batch, framebits, seed=framebits + 1)
    dec = _jax_decisions(syms, framebits)
    want = np.asarray(jax_tb.chainback_words_pallas(
        jnp.asarray(dec), framebits, interpret=True))
    dec_t = torch.from_numpy(dec.view(np.int32))
    before = _build.TB_WORDS.launches
    got = tb.chainback_words_cuda(dec_t, framebits)
    assert _build.TB_WORDS.launches == before   # the plain version on the CPU
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), golden.deconvolve_many(framebits,
                                                              syms))
    # the windows themselves: data bit t at bit 23 - t%24 of window t//24
    rs = tb.tb_words_plain(dec_t, framebits)
    bits = np.unpackbits(want, axis=1).T.reshape(framebits // 24, 24, -1)
    weights = (1 << np.arange(23, -1, -1))[None, :, None]
    assert np.array_equal(rs.numpy(), (bits * weights).sum(1))


def test_word_walk_reads_the_sign_bit():
    """Bit 31 of a word is int32's sign bit: a walk through state 31 and
    63 must read it as a decision, not as a sign."""
    framebits = 48
    dec = torch.full((framebits + 6, 2, 2), -1, dtype=torch.int32)
    # every decision 1: the walk goes 0 -> 32 -> 48 -> ... -> 63 and stays
    rs = tb.tb_words_plain(dec, framebits)
    assert (rs == (1 << 24) - 1).all()
    dec = torch.full((framebits + 6, 2, 2), 2**31 - 1, dtype=torch.int32)
    # bit 31 clear: state 63 (word 1, bit 31) decodes a 0 and leaves
    rs = tb.tb_words_plain(dec, framebits)
    assert np.array_equal(tb.chainback_words_cuda(dec, framebits).numpy(),
                          tb.chainback_scan(dec, framebits).numpy())
    assert (rs != (1 << 24) - 1).any()


@pytest.mark.parametrize("framebits", [0, 64, 100])
def test_word_walk_rejects_off_window_framebits(framebits):
    dec = torch.zeros((framebits + 6, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="24"):
        tb.tb_words(dec, framebits)


@pytest.mark.parametrize("block", [8, 24, 64])
@pytest.mark.parametrize("batch", [3, 17])
def test_chainback_blocked_matches_jax(block, batch):
    framebits = 192
    _, syms = channel.make_frames(batch, framebits, seed=block + batch)
    dec = _jax_decisions(syms, framebits)
    want = np.asarray(jax_tb.chainback_blocked(jnp.asarray(dec), framebits,
                                               block=block))
    got = tb.chainback_blocked(torch.from_numpy(dec.view(np.int32)),
                               framebits, block=block)
    assert np.array_equal(got.numpy(), want)


def test_chainback_blocked_rejects_a_block_that_does_not_divide():
    dec = torch.zeros((102, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of block"):
        tb.chainback_blocked(dec, 96, block=64)


def test_golden_many_matches_one_frame_at_a_time():
    """The port's many-frame oracle against the JAX package's one-frame
    golden model, frame for frame, and its batched branch metric against
    the JAX package's one step at a time."""
    _, syms = channel.make_frames(5, 100, seed=6, ebn0_db=1.0)
    want = np.stack([jax_golden.deconvolve(100, s) for s in syms])
    assert np.array_equal(golden.deconvolve_many(100, syms), want)
    steps = syms.reshape(-1, 4)
    assert np.array_equal(golden.branch_metrics(steps), np.stack(
        [jax_golden.branch_metrics(s) for s in steps]))
