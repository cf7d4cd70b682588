"""The staged ingest (``runtime.placement.ingest_words``): a large host
input narrowed to one byte a symbol through a fixed ring of host chunks,
which is, byte for byte, the frame-major packed words that kernels A and
C and their plain versions read (``ops.acs_cuda.pack_symbols_host``).
On the CPU the ring's chunks are plain memory and its copies are plain
copies; the card tests run the pinned ring, its side stream and events.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import viterbi_tpu_torch
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.models import dab
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.runtime import calllog, placement
from viterbi_tpu_torch.runtime import config as config_mod

CPU = torch.device("cpu")
FRAMEBITS = 96
KBPS = 8


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    viterbi_tpu_torch.initialize(device="cpu")
    calllog.spans(clear=True)
    yield
    calllog.spans(clear=True)
    viterbi_tpu_torch.initialize()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pinned ring's copies and "
                    "events run only on the card)")
    return torch.device("cuda", 0)


def _symbols(shape, dtype, seed=0, low=-1000, high=1000):
    info = np.iinfo(dtype)
    return np.random.default_rng(seed).integers(
        max(low, info.min), min(high, info.max), shape, dtype=dtype,
        endpoint=True)


def _words(a: np.ndarray) -> np.ndarray:
    """The packed words of unpacked symbols ``a`` [..., 4T], as the
    direct path's int32 cast and the kernels' low-byte load read them."""
    flat = a.reshape(-1, a.shape[-1])
    return acs_cuda.pack_symbols_host(flat.astype(np.int64)).reshape(
        *a.shape[:-1], a.shape[-1] // 4)


#: (host array, chunk bytes): values outside 0..255 and negatives
#: (wrapping casts), uint8, int64 and uint32 inputs, non-contiguous rows
#: and columns, a chunk boundary inside a row, a total that is not a
#: multiple of the chunk, a chunk of many rows
NARROW_CASES = {
    "int32_wide_values": (_symbols((9, 40), np.int32, 1, -2**31, 2**31 - 1),
                          64),
    "int32_negatives": (_symbols((5, 24), np.int32, 2, -300, -1), 24),
    "uint8": (_symbols((7, 16), np.uint8, 3, 0, 255), 40),
    "int64": (_symbols((6, 12), np.int64, 4, -2**40, 2**40), 50),
    "uint32": (_symbols((4, 20), np.uint32, 5, 0, 2**32 - 1), 33),
    "rows_and_columns_strided": (
        _symbols((12, 64), np.int32, 6)[::3, 8:40], 20),
    "columns_strided": (_symbols((5, 48), np.int32, 7)[:, ::2], 16),
    "boundary_inside_a_row": (_symbols((3, 100), np.int32, 8), 70),
    "total_not_a_multiple": (_symbols((10, 8), np.int32, 9), 30),
    "chunk_of_many_rows": (_symbols((40, 8), np.int32, 10), 100),
}


@pytest.mark.parametrize("case", list(NARROW_CASES))
def test_the_narrowing_gives_the_packed_words(case, monkeypatch):
    monkeypatch.setattr(placement, "STAGE_MIN_BYTES", 1)
    a, chunk = NARROW_CASES[case]
    ring = placement.StagingRing(CPU, chunks=2, chunk_bytes=chunk)
    assert not any(c.is_pinned() for c in ring.chunks)
    src = placement._host_integers(a, CPU)
    assert src is not None
    dst = torch.full((a.size,), 0xA5, dtype=torch.uint8)
    n = ring.upload(src.reshape(-1, a.shape[-1]), dst)
    assert n == -(-a.size // chunk)
    got = dst.view(torch.int32).view(*a.shape[:-1], a.shape[-1] // 4)
    assert np.array_equal(got.numpy(), _words(a))


def test_the_narrowing_takes_any_chunk_range():
    """``narrow_rows`` over every range [a, b) of a small array: a part
    of one row, across a row's end, whole rows between partial ones."""
    a = _symbols((4, 12), np.int32, 11)
    src = torch.from_numpy(a)
    want = a.astype(np.uint8).reshape(-1)
    for lo in range(a.size):
        for hi in range(lo + 1, a.size + 1):
            out = torch.empty(hi - lo, dtype=torch.uint8)
            placement.narrow_rows(src, lo, hi, out)
            assert np.array_equal(out.numpy(), want[lo:hi]), (lo, hi)


def _ingest_traced(a):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = placement.ingest_words(a, CPU)
    (rec,) = [r for r in calllog.spans() if r.name == "ingest"]
    calllog.spans(clear=True)
    return got, rec.counters


@pytest.mark.parametrize("below", [16, 0], ids=["just_under", "at"])
def test_the_input_size_selects_the_path(below):
    """Just under ``STAGE_MIN_BYTES`` the direct path (int32 symbols, four
    bytes a symbol, no chunk); at it the staged one (packed words, one
    byte a symbol, the chunks of the ring)."""
    n = (placement.STAGE_MIN_BYTES - below) // 4
    a = _symbols((1, n), np.int32, 12)
    assert a.nbytes == placement.STAGE_MIN_BYTES - below and n % 4 == 0
    (syms, layout), counters = _ingest_traced(a)
    if below:
        assert layout is False
        assert syms.dtype == torch.int32 and syms.shape == a.shape
        assert torch.equal(syms, torch.from_numpy(a))
        assert counters == {"h2d_bytes": a.nbytes, "staged_chunks": 0}
    else:
        assert layout == "bt"
        assert syms.shape == (1, n // 4)
        assert np.array_equal(syms.numpy(), _words(a))
        assert counters == {
            "h2d_bytes": a.size,
            "staged_chunks": -(-a.size // placement.STAGE_CHUNK_BYTES)}


@pytest.mark.parametrize("case", ["float", "big_endian", "negative_stride",
                                  "steps_not_whole", "tensor_on_device"])
def test_what_cannot_be_narrowed_takes_the_direct_path(case, monkeypatch):
    monkeypatch.setattr(placement, "STAGE_MIN_BYTES", 16)
    a = _symbols((6, 32), np.int32, 13, 0, 255)
    data = {"float": a.astype(np.float64),
            "big_endian": a.astype(">i4"),
            "negative_stride": a[::-1],
            "steps_not_whole": a[:, :30],
            "tensor_on_device": torch.from_numpy(a)}[case]
    syms, layout = placement.ingest_words(data, CPU)
    assert layout is False
    want = np.ascontiguousarray(np.asarray(data), dtype=np.int32)
    assert torch.equal(syms, torch.from_numpy(want))


@pytest.fixture
def small_ring(monkeypatch):
    """Stage everything on the CPU, through a ring of 3 chunks of 1000
    bytes: a call crosses many chunks, with boundaries inside rows."""
    monkeypatch.setattr(placement, "STAGE_MIN_BYTES", 1)
    monkeypatch.setitem(placement._rings, CPU,
                        placement.StagingRing(CPU, chunks=3,
                                              chunk_bytes=1000))


def _direct(monkeypatch):
    monkeypatch.setattr(placement, "STAGE_MIN_BYTES", 1 << 62)


def test_staged_and_direct_decodes_are_equal_on_the_cpu(small_ring,
                                                         monkeypatch):
    """``deconvolve_batch`` and the DAB+ chain decode the same bytes and
    counts through both paths; the chain's uncorrectable superframe
    included."""
    bits, syms = channel.make_frames(6, FRAMEBITS, seed=14)
    audio, sf = channel.make_superframes(3, KBPS, seed=15, uncorrectable=1)
    staged = (viterbi_tpu_torch.deconvolve_batch(FRAMEBITS, syms),
              dab.decode_audio_superframes(sf, KBPS, device="cpu"))
    _direct(monkeypatch)
    direct = (viterbi_tpu_torch.deconvolve_batch(FRAMEBITS, syms),
              dab.decode_audio_superframes(sf, KBPS, device="cpu"))
    assert staged[0][0] == direct[0][0] == 0
    assert np.array_equal(staged[0][1], direct[0][1])
    assert np.array_equal(direct[0][1], np.packbits(bits, axis=1))
    for s, d in zip(staged[1], direct[1]):
        assert torch.equal(s, d)
    assert direct[1][1][0] == -1
    assert np.array_equal(direct[1][0][1:].numpy(),
                          audio[1:].reshape(2, -1))


def _uploads_at_once(device, arrays, rounds):
    """Each array uploaded ``rounds`` times by a thread of its own, all at
    once; the words each thread got back."""
    barrier = threading.Barrier(len(arrays), timeout=60)
    got = [[] for _ in arrays]

    def upload(i):
        barrier.wait()
        for _ in range(rounds):
            syms, layout = placement.ingest_words(arrays[i], device)
            assert layout == "bt"
            got[i].append(syms.cpu().numpy())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=upload, args=(i,))
                   for i in range(len(arrays))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return got


def test_threads_uploading_at_once_get_their_own_symbols(small_ring):
    arrays = [_symbols((5, 160), np.int32, 20 + i) for i in range(12)]
    got = _uploads_at_once(CPU, arrays, rounds=10)
    for a, words in zip(arrays, got):
        assert len(words) == 10
        assert all(np.array_equal(w, _words(a)) for w in words)


@pytest.mark.cuda
def test_on_the_card_staged_and_direct_decodes_are_equal(cuda,
                                                         monkeypatch):
    """On the card, with the default threshold: a batch one row above it
    through the default ring, and a batch across many chunks of a small
    pinned ring, decode the same bytes and RS counts as the direct path,
    in ``deconvolve_batch`` and the DAB+ chain."""
    viterbi_tpu_torch.initialize(device=cuda)
    width = 4 * (3072 + 6)
    rows = placement.STAGE_MIN_BYTES // (4 * width) + 1
    _, syms = channel.make_frames(rows, 3072, seed=30)
    sf_rows = placement.STAGE_MIN_BYTES // (4 * 5 * 4 * (24 * 96 + 6)) + 1
    audio, sf = channel.make_superframes(sf_rows, 96, seed=31,
                                         uncorrectable=1)

    def both():
        return (viterbi_tpu_torch.deconvolve_batch(3072, syms),
                [t.cpu() for t in dab.decode_audio_superframes(sf, 96)])

    def staged(chunk_bytes):
        calllog.spans(clear=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = both()
        chunks = [r.counters["staged_chunks"] for r in calllog.spans()
                  if r.name == "ingest"]
        # one byte a symbol
        assert chunks == [-(-a.size // chunk_bytes) for a in (syms, sf)]
        return out

    runs = [staged(placement.STAGE_CHUNK_BYTES)]
    small = 1 << 16
    monkeypatch.setitem(placement._rings, cuda,
                        placement.StagingRing(cuda, chunks=2,
                                              chunk_bytes=small))
    runs.append(staged(small))
    assert -(-syms.size // small) > 4
    _direct(monkeypatch)
    runs.append(both())
    for (ret, out), (audio_got, errors) in runs:
        assert ret == 0
        assert np.array_equal(out, runs[-1][0][1])
        assert torch.equal(audio_got, runs[-1][1][0])
        assert torch.equal(errors, runs[-1][1][1])
    assert runs[-1][1][1][0] == -1


@pytest.mark.cuda
def test_on_the_card_threads_uploading_at_once_get_their_own_symbols(
        cuda, monkeypatch):
    monkeypatch.setitem(placement._rings, cuda,
                        placement.StagingRing(cuda, chunks=2,
                                              chunk_bytes=1 << 20))
    n = placement.STAGE_MIN_BYTES // 4 + 4096
    arrays = [_symbols((4, n // 4), np.int32, 40 + i) for i in range(6)]
    got = _uploads_at_once(cuda, arrays, rounds=4)
    for a, words in zip(arrays, got):
        assert len(words) == 4
        assert all(np.array_equal(w, _words(a)) for w in words)
