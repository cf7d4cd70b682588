"""The port's ring-streaming decoder (``parallel.streaming.
make_stream_decoder`` / ``decode_stream``) against the JAX package's
sharded ring, bit for bit, on thread ranks of one process: the plain form
against JAX's XLA form on (1, 8) and (2, 4) meshes, the kernel form (the
kernels' plain versions here) against JAX's Pallas form in interpret mode
on (1, 8); the ring against the port's ``make_local_stream_decoder`` of
as many blocks at the production block of 3072 bits; the small-block
clamp, the checkpoint alignment and the error texts of tiny blocks (the
cases of ``tests/test_parallel.py``). On the card (marker ``cuda``)
thread ranks that share ``cuda:0`` each launch kernel A twice and kernel
B once, equal to the local decoder."""

import numpy as np
import pytest
import torch
from torch_ranks import cpu_mesh, on_card, thread_ranks

from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.ops import _build
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops import traceback as tb
from viterbi_tpu_torch.parallel import distributed
from viterbi_tpu_torch.parallel import streaming as TS


@pytest.fixture
def kernel_form(monkeypatch):
    """Take the ring's kernel form on the CPU: the kernels then run as
    their plain versions (``use_kernels=True`` is refused on the CPU)."""
    monkeypatch.setattr(TS, "want_kernels", lambda use, device: True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda", 0)


def _ring(syms, framebits, n_data, n_seq, **kw):
    """``decode_stream`` on n_data * n_seq thread ranks: every rank's
    output as numpy."""
    return [o.numpy() for o in thread_ranks(
        lambda r, n, st: TS.decode_stream(
            syms, framebits, cpu_mesh(n_data, n_seq, r, n, st), **kw),
        n_data * n_seq)]


def _jax_ring(syms, framebits, n_data, n_seq, pallas, **kw):
    from viterbi_tpu.parallel import mesh as JM
    from viterbi_tpu.parallel import streaming as JS
    return np.asarray(JS.decode_stream(
        syms.astype(np.int32), framebits,
        JM.make_mesh(n_data=n_data, n_seq=n_seq), use_pallas=pallas,
        interpret=pallas, **kw))


@pytest.mark.parametrize("n_data,n_seq", [(1, 8), (2, 4)])
def test_ring_matches_jax_xla_form(n_data, n_seq):
    framebits = 384 * n_seq          # 384 bits a block
    B = 2 * n_data
    _, syms = channel.make_frames(B, framebits, seed=n_seq)
    want = _jax_ring(syms, framebits, n_data, n_seq, False)
    assert np.array_equal(want, golden.deconvolve_many(framebits, syms))
    for got in _ring(syms, framebits, n_data, n_seq, use_kernels=False):
        assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_ring_kernel_form_matches_jax_pallas_form(kernel_form):
    framebits, n_seq = 384 * 8, 8
    _, syms = channel.make_frames(2, framebits, seed=n_seq)
    want = _jax_ring(syms, framebits, 1, n_seq, True)
    for got in _ring(syms, framebits, 1, n_seq):
        assert np.array_equal(got, want)


def test_ring_kernel_form_on_two_axes_matches_golden(kernel_form):
    framebits = 384 * 4
    _, syms = channel.make_frames(4, framebits, seed=4)
    want = golden.deconvolve_many(framebits, syms)
    for got in _ring(syms, framebits, 2, 4):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("kernels", [False, True])
def test_ring_equals_the_local_decoder_at_the_production_block(monkeypatch,
                                                               kernels):
    """3072 bits a block x 8 seq ranks, B = 64, in both forms: the same
    mechanism as the local decoder of 8 blocks folded into the batch, bit
    for bit."""
    stream_bits, n_seq, B = 3072 * 8, 8, 64
    _, syms = channel.make_frames(B, stream_bits, seed=5)
    data, tail = syms[:, :4 * stream_bits], syms[:, 4 * stream_bits:]
    blk = stream_bits // n_seq
    if kernels:
        monkeypatch.setattr(TS, "want_kernels", lambda use, device: True)
        ovl, warm, ckpt = TS._plan_block_layout(blk, None, None, True)
        want = TS.decode_kernels(torch.from_numpy(data),
                                 torch.from_numpy(tail), n_seq, blk, ovl,
                                 warm, ckpt).numpy()
    else:
        want = TS.make_local_stream_decoder(
            stream_bits, n_seq, use_kernels=False,
            device="cpu")(data, tail).numpy()
    got = thread_ranks(lambda r, n, st: TS.make_stream_decoder(
        cpu_mesh(1, n_seq, r, n, st), stream_bits,
        use_kernels=None if kernels else False)(data, tail), n_seq)
    for out in got:
        assert np.array_equal(out.numpy(), want)


def test_ring_small_blocks_clamp_default_overlap():
    """Blocks of 64 bits, below DEFAULT_OVERLAP: the default clamps; an
    explicit overlap that does not fit raises on every rank."""
    framebits = 64 * 8
    _, syms = channel.make_frames(4, framebits, seed=11)
    want = _jax_ring(syms, framebits, 1, 8, False)
    for got in _ring(syms, framebits, 1, 8, use_kernels=False):
        assert np.array_equal(got, want)
    assert np.array_equal(want, golden.deconvolve_many(framebits, syms))
    with pytest.raises(ValueError, match="overlap"):
        _ring(syms, framebits, 1, 8, overlap=96, use_kernels=False)


def test_ring_small_blocks_kernel_form_checkpoint_alignment(kernel_form):
    """Blocks of 48 bits, checkpoint 18: the clamped default overlap
    aligns down, as in JAX's Pallas form."""
    framebits = 48 * 8
    _, syms = channel.make_frames(2, framebits, seed=12)
    want = _jax_ring(syms, framebits, 1, 8, True)
    assert np.array_equal(want, golden.deconvolve_many(framebits, syms))
    for got in _ring(syms, framebits, 1, 8):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("framebits,kernels", [
    (12 * 8, True), (12 * 8, False), (30 * 8, True)])
def test_ring_tiny_blocks_raise_the_jax_error_texts(monkeypatch, framebits,
                                                    kernels):
    """The shared layout's descriptive errors, on every rank, before any
    exchange; the texts are JAX's with its Pallas form named the kernel
    form."""
    from viterbi_tpu.parallel import mesh as JM
    from viterbi_tpu.parallel import streaming as JS
    if kernels:
        monkeypatch.setattr(TS, "want_kernels", lambda use, device: True)
    _, syms = channel.make_frames(2, framebits, seed=13)
    with pytest.raises(ValueError, match="more data bits per device") as e:
        JS.decode_stream(syms.astype(np.int32), framebits,
                         JM.make_mesh(n_data=1, n_seq=8),
                         use_pallas=kernels, interpret=kernels)
    want = str(e.value).replace("use_pallas", "use_kernels") \
        .replace("pallas streaming", "kernel streaming")
    with pytest.raises(ValueError) as got:
        _ring(syms, framebits, 1, 8, use_kernels=None if kernels else False)
    assert str(got.value) == want


def test_ring_noiseless_long_stream_matches_the_bits():
    framebits = 8 * 1024
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (1, framebits), dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits[0]))[None]
    for got in _ring(syms.astype(np.int32), framebits, 1, 8,
                     use_kernels=False):
        assert np.array_equal(got, np.packbits(bits, axis=1))


def test_ring_takes_tensors_and_checks_shapes():
    stream_bits = 2 * 96
    _, syms = channel.make_frames(2, stream_bits, seed=3)
    data = torch.from_numpy(syms[:, :4 * stream_bits])
    tail = torch.from_numpy(syms[:, 4 * stream_bits:])

    def rank(r, n, st):
        dec = TS.make_stream_decoder(cpu_mesh(1, 2, r, n, st), stream_bits,
                                     use_kernels=False)
        out = dec(data, tail)
        with pytest.raises(ValueError, match="tail"):
            dec(data, tail[:, :-1])
        with pytest.raises(ValueError, match="symbols must be"):
            dec(data[:, :-4], tail)
        return out

    for out in thread_ranks(rank, 2):
        assert out.dtype == torch.uint8 and np.array_equal(
            out.numpy(), golden.deconvolve_many(stream_bits, syms))


def test_ring_refuses_a_stream_that_does_not_divide():
    with pytest.raises(ValueError, match="do not divide"):
        thread_ranks(lambda r, n, st: TS.make_stream_decoder(
            cpu_mesh(1, 3, r, n, st), 3 * 96 + 8, use_kernels=False), 3)


def test_decode_stream_without_a_mesh_needs_a_job(monkeypatch):
    monkeypatch.setattr(distributed, "_initialized", False)
    _, syms = channel.make_frames(1, 96, seed=0)
    with pytest.raises(RuntimeError, match="initialize"):
        TS.decode_stream(syms, 96)


def test_ring_exchanges_are_the_only_traffic(monkeypatch):
    """Two exchanges a rank and call (boundary metrics right, overlap
    prefix left), sized as the JAX ring's ppermutes: int32 [B, 64] and
    the overlap's packed words [B, overlap] in the kernel form."""
    from viterbi_tpu_torch.parallel import mesh as M
    monkeypatch.setattr(TS, "want_kernels", lambda use, device: True)
    sent, real = [], M.exchange

    def spy(group, tensor, dst, src, tag=0):
        sent.append((tag, tuple(tensor.shape), dst is not None))
        return real(group, tensor, dst, src, tag)

    monkeypatch.setattr(M, "exchange", spy)
    stream_bits = 4 * 384
    _, syms = channel.make_frames(2, stream_bits, seed=9)
    _ring(syms, stream_bits, 1, 4)
    ovl = TS._plan_block_layout(384, None, None, True)[0]
    assert sorted(sent) == sorted(
        [(0, (2, 64), r < 3) for r in range(4)]
        + [(1, (2, ovl), r > 0) for r in range(4)])


# --- on the card: thread ranks that share cuda:0 ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_data,n_seq", [(1, 2), (1, 4), (2, 2)])
def test_card_ring_equals_the_local_decoder(cuda, n_data, n_seq):
    stream_bits, B = 3072 * n_seq, 8 * n_data
    _, syms = channel.make_frames(B, stream_bits, seed=n_seq)
    data = torch.from_numpy(syms[:, :4 * stream_bits]).to(cuda)
    tail = torch.from_numpy(syms[:, 4 * stream_bits:]).to(cuda)
    want = TS.make_local_stream_decoder(stream_bits, n_seq)(data, tail)
    a0, b0 = _build.ACS_REGS.launches, _build.TB_WALK.launches
    got = thread_ranks(lambda r, n, st: TS.make_stream_decoder(
        on_card(r, n, st, n_data, n_seq), stream_bits)(data, tail),
        n_data * n_seq)
    ranks = n_data * n_seq
    assert _build.ACS_REGS.launches - a0 == 2 * ranks
    assert _build.TB_WALK.launches - b0 == ranks
    for out in got:
        assert out.is_cuda and torch.equal(out, want)
    plain = TS.make_local_stream_decoder(stream_bits, n_seq,
                                         use_kernels=False)(data, tail)
    assert torch.equal(plain, want)
