"""The port's one-card block-overlap streaming against the JAX package's,
bit for bit: ``_plan_block_layout`` over a grid of blocks and overlaps
(errors included), ``make_local_stream_decoder``'s plain form against the
JAX XLA form and its kernel form (the kernels' plain versions here)
against the JAX Pallas form in interpret mode, both against the
whole-stream decode; the small-block cases of ``tests/test_parallel.py``
at their block sizes; the anchored walk against the JAX one. On the card
(marker ``cuda``) the kernel form against the plain form."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.ops import _build
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops import traceback as tb
from viterbi_tpu_torch.parallel import streaming as TS


def _jax():
    """The JAX package's side, imported by the tests that compare with it:
    the card's machine has no JAX and runs only this file's card tests."""
    import jax
    import jax.numpy as jnp

    import viterbi_tpu.ops.traceback as JTB
    import viterbi_tpu.parallel.streaming as JS
    from viterbi_tpu import constants as JC
    from viterbi_tpu.ops import acs as jacs
    return jax, jnp, JTB, JS, JC, jacs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda", 0)


def _whole_stream_decode(syms, stream_bits):
    """The JAX package's whole-stream decode (XLA forward + blocked
    chainback, bit-exact vs golden in its own tests)."""
    jax, jnp, JTB, JS, JC, jacs = _jax()

    @jax.jit
    def whole(s):
        decisions, _ = jacs.forward(s, stream_bits + JC.TAIL_BITS)
        return JTB.chainback_blocked(decisions, stream_bits, block=64)
    return np.asarray(whole(jnp.asarray(syms)))


def _stream(B, stream_bits, seed):
    _, syms = channel.make_frames(B, stream_bits, seed=seed)
    syms = syms.astype(np.int32)
    return syms[:, :4 * stream_bits], syms[:, 4 * stream_bits:], syms


def _port(data, tail, stream_bits, n_blocks, kernels, **kw):
    """The port's decoder in one form on the CPU."""
    if not kernels:
        dec = TS.make_local_stream_decoder(stream_bits, n_blocks,
                                           use_kernels=False, device="cpu",
                                           **kw)
        return dec(data, tail).numpy()
    blk = stream_bits // n_blocks
    ovl, warm, ckpt = TS._plan_block_layout(blk, kw.get("overlap"),
                                            kw.get("warmup"), True)
    return TS.decode_kernels(torch.from_numpy(data), torch.from_numpy(tail),
                             n_blocks, blk, ovl, warm, ckpt).numpy()


def _jax_decode(data, tail, stream_bits, n_blocks, kernels, **kw):
    jax, jnp, JTB, JS, JC, jacs = _jax()
    dec = JS.make_local_stream_decoder(stream_bits, n_blocks,
                                       use_pallas=kernels,
                                       interpret=kernels, **kw)
    return np.asarray(dec(data, tail))


def _plan_or_error(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


def test_constants_match():
    jax, jnp, JTB, JS, JC, jacs = _jax()
    assert (TS.DEFAULT_OVERLAP, TS.WARMUP_STEPS) == \
        (JS.DEFAULT_OVERLAP, JS.WARMUP_STEPS)


def _jax_plan(blk, overlap, warmup, kernels):
    """The JAX layout or error text, with its Pallas form named as the
    port names its kernel form."""
    jax, jnp, JTB, JS, JC, jacs = _jax()
    want = _plan_or_error(JS._plan_block_layout, blk, overlap, warmup,
                          kernels)
    if want[0] == "ValueError":
        want = (want[0], want[1].replace("use_pallas", "use_kernels")
                .replace("pallas streaming", "kernel streaming"))
    return want


@settings(max_examples=400, deadline=None, database=None)
@given(blk=st.integers(0, 640),
       overlap=st.one_of(st.none(), st.integers(0, 200)),
       warmup=st.one_of(st.none(), st.integers(0, 300)),
       kernels=st.booleans())
def test_plan_block_layout_matches_jax(blk, overlap, warmup, kernels):
    """Same layout or the same error text."""
    assert _plan_or_error(TS._plan_block_layout, blk, overlap, warmup,
                          kernels) == _jax_plan(blk, overlap, warmup, kernels)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("blk,overlap", [(768, None), (480, None),
                                         (48, None), (64, 96), (12, None),
                                         (30, None), (3072, 16), (64, None),
                                         (48, 48)])
def test_plan_block_layout_cases(blk, overlap, kernels):
    """The block sizes of the tests below, every error path among them."""
    assert _plan_or_error(TS._plan_block_layout, blk, overlap, None,
                          kernels) == _jax_plan(blk, overlap, None, kernels)


@pytest.mark.parametrize("kernels", [False, True])
def test_local_stream_decoder_matches_jax_and_whole(kernels):
    """test_parallel.py::test_local_stream_decoder_matches_whole: 4 blocks
    of 768 bits, noisy 3 dB frames, each form against its JAX twin."""
    n_blocks, stream_bits = 4, 768 * 4
    data, tail, syms = _stream(2, stream_bits, seed=31)
    got = _port(data, tail, stream_bits, n_blocks, kernels)
    assert np.array_equal(got, _jax_decode(data, tail, stream_bits, n_blocks,
                                    kernels))
    assert np.array_equal(got, _whole_stream_decode(syms, stream_bits))


def test_local_stream_decoder_long_stream_kernel_form():
    """test_parallel.py::test_local_stream_decoder_long_stream_pallas: a
    24576-bit stream in 8 blocks of 3072 through the kernel form."""
    n_blocks, stream_bits = 8, 3072 * 8
    data, tail, syms = _stream(2, stream_bits, seed=32)
    got = _port(data, tail, stream_bits, n_blocks, True)
    assert np.array_equal(got, _jax_decode(data, tail, stream_bits, n_blocks, True))
    assert np.array_equal(got, _whole_stream_decode(syms, stream_bits))


def test_local_stream_decoder_production_blocks_plain_form():
    """3072-bit blocks, 8 of them, B = 16: the plain form against the JAX
    XLA form and the whole-stream decode."""
    n_blocks, stream_bits = 8, 3072 * 8
    data, tail, syms = _stream(16, stream_bits, seed=5)
    got = _port(data, tail, stream_bits, n_blocks, False)
    assert np.array_equal(got, _jax_decode(data, tail, stream_bits, n_blocks, False))
    assert np.array_equal(got, _whole_stream_decode(syms, stream_bits))


def test_small_blocks_clamp_default_overlap():
    """test_parallel.py::test_streaming_small_blocks_clamp_default_overlap
    on one card: 64-bit blocks take the clamped default overlap; an
    explicit overlap that does not fit raises the same error."""
    jax, jnp, JTB, JS, JC, jacs = _jax()
    stream_bits, n_blocks = 64 * 8, 8
    data, tail, syms = _stream(4, stream_bits, seed=11)
    got = _port(data, tail, stream_bits, n_blocks, False)
    assert np.array_equal(got, _jax_decode(data, tail, stream_bits, n_blocks, False))
    want = np.stack([golden.deconvolve(stream_bits, s) for s in syms])
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="overlap") as t_err:
        TS.make_local_stream_decoder(stream_bits, n_blocks, overlap=96,
                                     use_kernels=False, device="cpu")
    with pytest.raises(ValueError) as j_err:
        JS.make_local_stream_decoder(stream_bits, n_blocks, overlap=96,
                                     use_pallas=False)
    assert str(t_err.value) == str(j_err.value)


def test_small_blocks_kernel_checkpoint_alignment():
    """test_parallel.py::test_streaming_small_blocks_pallas_ckpt_alignment
    on one card: 48-bit blocks, checkpoint 18, clamped and aligned down."""
    stream_bits, n_blocks = 48 * 8, 8
    assert TS._plan_block_layout(48, None, None, True)[2] == 18
    data, tail, syms = _stream(2, stream_bits, seed=12)
    got = _port(data, tail, stream_bits, n_blocks, True)
    assert np.array_equal(got, _jax_decode(data, tail, stream_bits, n_blocks, True))
    want = np.stack([golden.deconvolve(stream_bits, s) for s in syms])
    assert np.array_equal(got, want)


def test_rounded_overlap_kernel_form():
    """480-bit blocks: checkpoint 18, the overlap rounded up to 132, the
    last block anchored below the top checkpoint."""
    assert TS._plan_block_layout(480, None, None, True) == (132, 126, 18)
    stream_bits, n_blocks = 480 * 4, 4
    data, tail, syms = _stream(3, stream_bits, seed=13)
    got = _port(data, tail, stream_bits, n_blocks, True)
    assert np.array_equal(got, _port(data, tail, stream_bits, n_blocks,
                                     False))
    assert np.array_equal(got, _whole_stream_decode(syms, stream_bits))


@pytest.mark.parametrize("blk,kernels", [(12, True), (12, False),
                                         (30, True)])
def test_tiny_blocks_raise_descriptive_errors(blk, kernels):
    """test_parallel.py::test_streaming_tiny_blocks_raise_descriptive_errors
    on one card: the same text from the port and the JAX decoder."""
    jax, jnp, JTB, JS, JC, jacs = _jax()
    with pytest.raises(ValueError, match="more data bits per device") as j:
        JS.make_local_stream_decoder(blk * 8, 8, use_pallas=kernels,
                                     interpret=kernels)
    with pytest.raises(ValueError, match="more data bits per device") as t:
        if kernels:
            TS._plan_block_layout(blk, None, None, True)
        else:
            TS.make_local_stream_decoder(blk * 8, 8, use_kernels=False,
                                         device="cpu")
    assert str(t.value) == str(j.value)


def test_noiseless_long_stream():
    stream_bits = 8 * 1024
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (1, stream_bits), dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits[0]))[None].astype(np.int32)
    dec = TS.make_local_stream_decoder(stream_bits, 8, device="cpu")
    out = dec(syms[:, :4 * stream_bits], syms[:, 4 * stream_bits:])
    assert np.array_equal(out.numpy(), np.packbits(bits, axis=1))


def test_anchored_walk_matches_jax():
    """chainback_regs_cuda_anchored against chainback_regs_pallas_anchored
    (interpret mode) on kernel A's checkpoints with random anchors."""
    jax, jnp, JTB, JS, JC, jacs = _jax()
    rng = np.random.default_rng(3)
    B, nsteps, ckpt = 5, 144, 24
    words = rng.integers(0, 2**31, (B, nsteps), dtype=np.int64) \
        .astype(np.int32)
    regs, _ = acs_cuda.forward_regs(torch.from_numpy(words), nsteps,
                                    ckpt=ckpt, packed="bt")
    K = regs.shape[0]
    k = rng.integers(0, K, B).astype(np.int32)
    a = rng.integers(0, 64, B).astype(np.int32)
    got = tb.chainback_regs_cuda_anchored(regs, torch.from_numpy(k),
                                          torch.from_numpy(a), 96, ckpt)
    want = JTB.chainback_regs_pallas_anchored(
        jnp.asarray(regs.numpy()), jnp.asarray(k), jnp.asarray(a), 96, ckpt,
        interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="whole bytes"):
        tb.chainback_regs_cuda_anchored(regs, torch.from_numpy(k),
                                        torch.from_numpy(a), 92, ckpt)


def test_anchored_chainback_matches_jax():
    jax, jnp, JTB, JS, JC, jacs = _jax()
    rng = np.random.default_rng(4)
    T, B = 40, 6
    dec = rng.integers(-2**31, 2**31, (T, B, 2), dtype=np.int64) \
        .astype(np.int32)
    j = rng.integers(0, T, B).astype(np.int32)
    a = rng.integers(0, 64, B).astype(np.int32)
    got = TS._anchored_chainback(torch.from_numpy(dec), torch.from_numpy(j),
                                 torch.from_numpy(a), T, 24)
    want = JS._anchored_chainback(jnp.asarray(dec.view(np.uint32)),
                                  jnp.asarray(j), jnp.asarray(a), T, 24)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_entry_points_and_validation():
    data, tail, _ = _stream(2, 768 * 2, seed=8)
    dec = TS.make_local_stream_decoder(768 * 2, 2, device="cpu")
    out = dec(torch.from_numpy(data), torch.from_numpy(tail))
    assert out.dtype == torch.uint8 and out.shape == (2, 192)
    assert np.array_equal(out.numpy(), dec(data, tail).numpy())
    with pytest.raises(ValueError, match="tail symbols"):
        dec(data, tail[:, :8])
    with pytest.raises(ValueError, match="CUDA"):
        TS.make_local_stream_decoder(768 * 2, 2, use_kernels=True,
                                     device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("blk,n_blocks", [(3072, 4), (480, 6), (48, 8)])
def test_card_kernel_form_matches_plain(cuda, blk, n_blocks):
    """On the card: two launches of kernel A and one of kernel B a call,
    equal to the plain form on the card and to the whole-stream decode."""
    stream_bits = blk * n_blocks
    data, tail, syms = _stream(3, stream_bits, seed=blk)
    d, t = torch.from_numpy(data).to(cuda), torch.from_numpy(tail).to(cuda)
    dec = TS.make_local_stream_decoder(stream_bits, n_blocks)
    a0, b0 = _build.ACS_REGS.launches, _build.TB_WALK.launches
    got = dec(d, t)
    assert (_build.ACS_REGS.launches - a0,
            _build.TB_WALK.launches - b0) == (2, 1)
    plain = TS.make_local_stream_decoder(stream_bits, n_blocks,
                                         use_kernels=False)(d, t)
    assert torch.equal(got, plain)
    whole = acs_cuda.decode(torch.from_numpy(syms).to(cuda), stream_bits)
    assert torch.equal(got, whole)
