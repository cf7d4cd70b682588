"""The port's ``StreamSession`` against the JAX package's, bit for bit:
the cases of ``tests/test_parallel.py`` (one-shot equality for 24 ms
chunks of one and five frames, tiny irregular pushes, a custom overlap,
the same error texts), each in the plain form against the JAX XLA form
and in the kernel form (the kernels' plain versions here) against the
JAX Pallas form in interpret mode. On the card (marker ``cuda``) the
three-launch push against the plain push."""

import numpy as np
import pytest
import torch

from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.ops import _build
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops import traceback as tb
from viterbi_tpu_torch.parallel import StreamSession
from viterbi_tpu_torch.parallel import session as TSS


def _jax():
    """The JAX package's side, imported by the tests that compare with it:
    the card's machine has no JAX and runs only this file's card tests."""
    import jax
    import jax.numpy as jnp

    import viterbi_tpu.ops.traceback as JTB
    from viterbi_tpu import constants as JC
    from viterbi_tpu.ops import acs as jacs
    from viterbi_tpu.parallel import StreamSession as JSession
    return jax, jnp, JTB, JC, jacs, JSession


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda", 0)


def _whole_stream_decode(syms, stream_bits):
    jax, jnp, JTB, JC, jacs, JSession = _jax()

    @jax.jit
    def whole(s):
        decisions, _ = jacs.forward(s, stream_bits + JC.TAIL_BITS)
        return JTB.chainback_blocked(decisions, stream_bits, block=64)
    return np.asarray(whole(jnp.asarray(syms)))


def _session(B, kernels, **kw):
    """The port's session on the CPU in one form: the kernel form runs
    the kernels' wrappers, which on CPU tensors run their plain versions."""
    sess = StreamSession(B, device="cpu", **kw)
    sess.use_kernels = kernels
    return sess


def _run(sess, data, tail, cuts):
    outs = [sess.push(data[:, a:b]) for a, b in zip(cuts, cuts[1:])]
    outs.append(sess.flush(tail))
    return np.concatenate(outs, axis=1)


def _stream(B, stream_bits, seed):
    _, syms = channel.make_frames(B, stream_bits, seed=seed)
    syms = syms.astype(np.int32)
    return syms[:, :4 * stream_bits], syms[:, 4 * stream_bits:], syms


@pytest.mark.parametrize("chunk_frames", [1, 5])
@pytest.mark.parametrize("kernels", [False, True])
def test_session_matches_jax_and_one_shot(chunk_frames, kernels):
    """test_parallel.py::test_stream_session_matches_one_shot: 24 ms
    frames of 768 bits, ten of them, pushed one or five at a time."""
    jax, jnp, JTB, JC, jacs, JSession = _jax()
    framebits, n_frames, B = 768, 10, 2
    stream_bits = framebits * n_frames
    data, tail, syms = _stream(B, stream_bits, seed=41)
    step = 4 * framebits * chunk_frames
    cuts = list(range(0, data.shape[1], step)) + [data.shape[1]]
    sess = _session(B, kernels)
    got = _run(sess, data, tail, cuts)
    assert got.shape[1] == stream_bits // 8
    assert sess.emitted_bits == stream_bits
    assert np.array_equal(got, _whole_stream_decode(syms, stream_bits))
    jsess = JSession(B, use_pallas=kernels, interpret=kernels)
    assert np.array_equal(got, _run(jsess, data, tail, cuts))
    with pytest.raises(RuntimeError, match="already flushed") as t_err:
        sess.push(data[:, :step])
    with pytest.raises(RuntimeError) as j_err:
        jsess.push(data[:, :step])
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(RuntimeError, match="already flushed"):
        sess.flush(tail)


@pytest.mark.parametrize("kernels", [False, True])
def test_session_tiny_pushes(kernels):
    """test_parallel.py::test_stream_session_tiny_pushes_and_validation:
    irregular even-step chunks of 50, 96 and 238 steps, then the rest."""
    jax, jnp, JTB, JC, jacs, JSession = _jax()
    framebits, B = 480, 2
    data, tail, syms = _stream(B, framebits, seed=43)
    cuts = [0, 200, 584, 1536, data.shape[1]]
    got = _run(_session(B, kernels), data, tail, cuts)
    want = np.stack([golden.deconvolve(framebits, s) for s in syms])
    assert np.array_equal(got, want)
    assert np.array_equal(got, _run(JSession(B, use_pallas=False), data,
                                    tail, cuts))


@pytest.mark.parametrize("kernels", [False, True])
def test_session_partial_last_byte(kernels):
    """A stream of 500 bits: the flush decodes a rest that 8 does not
    divide, and its last byte is partial, as golden packs it."""
    jax, jnp, JTB, JC, jacs, JSession = _jax()
    framebits, B = 500, 3
    data, tail, syms = _stream(B, framebits, seed=44)
    cuts = [0, 800, 1200, data.shape[1]]
    sess = _session(B, kernels)
    got = _run(sess, data, tail, cuts)
    assert sess.emitted_bits == framebits
    want = np.stack([golden.deconvolve(framebits, s) for s in syms])
    assert np.array_equal(got, want)
    assert np.array_equal(got, _run(JSession(B, use_pallas=False), data,
                                    tail, cuts))


def test_session_custom_overlap():
    """test_parallel.py::test_stream_session_custom_overlap: a look-ahead
    of 48 steps still reproduces the one-shot decode at 3 dB."""
    jax, jnp, JTB, JC, jacs, JSession = _jax()
    framebits, n_frames, B = 768, 6, 2
    stream_bits = framebits * n_frames
    data, tail, syms = _stream(B, stream_bits, seed=51)
    step = 4 * framebits
    cuts = list(range(0, data.shape[1], step)) + [data.shape[1]]
    want = _whole_stream_decode(syms, stream_bits)
    for kernels in (False, True):
        got = _run(_session(B, kernels, overlap=48), data, tail, cuts)
        assert np.array_equal(got, want)
    assert np.array_equal(
        want, _run(JSession(B, overlap=48, use_pallas=False), data, tail,
                   cuts))


def test_session_validation_texts_match_jax():
    jax, jnp, JTB, JC, jacs, JSession = _jax()
    B = 2
    cases = [
        (lambda S: S(B), lambda s: s.push(np.zeros((B, 4), np.int32))),
        (lambda S: S(B), lambda s: s.push(np.zeros((3, 8), np.int32))),
        (lambda S: S(B), lambda s: s.push(np.zeros(8, np.int32))),
        (lambda S: S(B), lambda s: s.flush(np.zeros((B, 7), np.int32))),
        (lambda S: S(B, overlap=4), None),
    ]
    for make, call in cases:
        errs = []
        for S in (JSession, lambda *a, **k: StreamSession(*a, device="cpu",
                                                          **k)):
            with pytest.raises(ValueError) as err:
                s = make(S)
                call(s)
            errs.append(str(err.value))
        assert errs[0] == errs[1]


def test_session_state_between_pushes():
    """Nothing emitted while the look-ahead fills; pending steps and the
    emitted count move by whole 24-bit quanta."""
    B = 2
    data, tail, _ = _stream(B, 768, seed=45)
    sess = StreamSession(B, device="cpu")
    assert sess.push(data[:, :4 * 100]).shape == (B, 0)
    assert sess.pending_steps() == 100 and sess.emitted_bits == 0
    out = sess.push(data[:, 4 * 100:4 * 400])
    assert out.shape == (B, 264 // 8) and sess.emitted_bits == 264
    assert sess.pending_steps() == 400 - 264
    assert sess.pending_steps() >= sess.overlap
    assert sess.use_kernels is False and sess.device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA"):
        StreamSession(B, use_kernels=True, device="cpu")


def test_push_forms_agree_with_partial_checkpoint():
    """push_kernels against push_plain on one push whose look-ahead ends
    inside a checkpoint period, from carried metrics that are not the
    terminated start."""
    rng = np.random.default_rng(9)
    B, seg_a, seg_b = 4, 96, 134
    words = torch.from_numpy(acs_cuda.pack_symbols_host(
        rng.integers(0, 256, (B, 4 * (seg_a + seg_b)), dtype=np.int32)))
    init = torch.from_numpy(rng.integers(0, 100, (B, 64)).astype(np.int32))
    out_k, m_k = TSS.push_kernels(words, init, seg_a, seg_b)
    out_p, m_p = TSS.push_plain(words, init, seg_a, seg_b)
    assert torch.equal(out_k, out_p) and torch.equal(m_k, m_p)
    for rest in (24, 30, 58):
        assert torch.equal(TSS.flush_kernels(words, init, rest),
                           TSS.flush_plain(words, init, rest))


@pytest.mark.cuda
def test_card_push_is_three_launches_and_matches_plain(cuda):
    """On the card a push launches kernel A twice and kernel B once; the
    session's bytes equal the plain session's on the card and the one-shot
    decode through kernels A and B."""
    framebits, n_frames, B = 3072, 6, 8
    stream_bits = framebits * n_frames
    data, tail, syms = _stream(B, stream_bits, seed=46)
    sess = StreamSession(B)
    assert sess.use_kernels and sess.device.type == "cuda"
    outs, pushes = [], 0
    a0, b0, c0 = (_build.ACS_REGS.launches, _build.TB_WALK.launches,
                  _build.ACS_WORDS.launches)
    for i in range(0, data.shape[1], 4 * framebits):
        outs.append(sess.push(data[:, i:i + 4 * framebits]))
        pushes += outs[-1].shape[1] > 0
    assert (_build.ACS_REGS.launches - a0, _build.TB_WALK.launches - b0,
            _build.ACS_WORDS.launches - c0) == (2 * pushes, pushes, 0)
    outs.append(sess.flush(tail))
    got = np.concatenate(outs, axis=1)
    plain = StreamSession(B, use_kernels=False)
    cuts = list(range(0, data.shape[1], 4 * framebits)) + [data.shape[1]]
    assert np.array_equal(got, _run(plain, data, tail, cuts))
    whole = acs_cuda.decode(torch.from_numpy(syms).to(cuda), stream_bits)
    assert np.array_equal(got, whole.cpu().numpy())
