"""The port's host ingest against the JAX package's: ``utils.native`` (the
library built from ``native/vitio.cpp`` under ``build/native/``, and its
numpy fall-backs) on the cases of ``tests/test_native.py``, and
``utils.pipeline.decode_pipelined`` against one call at a time. On the
card (marker ``cuda``) the pipelined decode through kernels A and B."""

import threading

import numpy as np
import pytest
import torch

import viterbi_tpu_torch
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import benchmark
from viterbi_tpu_torch.ops import acs, acs_cuda
from viterbi_tpu_torch.ops import traceback as tb
from viterbi_tpu_torch.runtime import config as config_mod
from viterbi_tpu_torch.utils import native, pipeline


def _jax():
    """The JAX package's side, imported by the tests that compare with it:
    the card's machine has no JAX and runs only this file's card tests."""
    import jax

    import viterbi_tpu.golden as JG
    import viterbi_tpu.utils.native as JN
    import viterbi_tpu.utils.pipeline as JP
    from viterbi_tpu import constants as JC
    from viterbi_tpu.ops import acs as jacs
    from viterbi_tpu.ops import traceback as jtb
    return jax, JG, JN, JP, JC, jacs, jtb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda", 0)


@pytest.fixture(params=["native", "numpy"])
def lib(request, monkeypatch):
    """Each case on the built library and on the numpy fall-backs."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
    elif not native.have_native():
        pytest.skip("no C++ compiler to build native/vitio.cpp")
    return request.param


def test_library_builds_under_build_native(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    viterbi_tpu_torch.initialize(device="cpu")     # the report's device
    path = native.library_path()
    assert path.parent.parent == native.ROOT / "build" / "native"
    assert native.have_native() == path.exists()
    assert f"native host lib: {native.have_native()}" in \
        benchmark.environment_report()


def test_encode_matches_jax_and_golden(lib):
    jax, JG, JN, JP, JC, jacs, jtb = _jax()
    rng = np.random.default_rng(0)
    for framebits in (1, 13, 768):
        bits = rng.integers(0, 2, framebits, dtype=np.uint8)
        got = native.encode(bits)
        assert got.dtype == np.uint8
        assert np.array_equal(got, golden.encode(bits))
        assert np.array_equal(got, JN.encode(bits))
        assert np.array_equal(got, JG.encode(bits))


def test_pack_bits_msb_first(lib):
    jax, JG, JN, JP, JC, jacs, jtb = _jax()
    rng = np.random.default_rng(1)
    for n in (10, 8, 1, 333):
        bits = rng.integers(0, 2, n, dtype=np.uint8)
        got = native.pack_bits(bits)
        assert np.array_equal(got, np.packbits(bits))
        assert np.array_equal(got, JN.pack_bits(bits))


def test_depuncture_mask(lib):
    jax, JG, JN, JP, JC, jacs, jtb = _jax()
    syms = np.arange(1, 7, dtype=np.uint32)
    mask = np.array([1, 1, 0, 1], dtype=np.uint8)   # drop every 3rd of 4
    out = native.depuncture(syms, mask, 8, fill=127)
    assert out.tolist() == [1, 2, 127, 3, 4, 5, 127, 6]
    rng = np.random.default_rng(2)
    mask = rng.integers(0, 2, 32, dtype=np.uint8)
    syms = rng.integers(0, 256, 500, dtype=np.uint32)
    for n_out in (0, 31, 600, 1200):
        got = native.depuncture(syms, mask, n_out, fill=9)
        assert np.array_equal(got, JN.depuncture(syms, mask, n_out, fill=9))


def test_rs_deinterleave_matches_reference_layout(lib):
    jax, JG, JN, JP, JC, jacs, jtb = _jax()
    rng = np.random.default_rng(1)
    for rs_dims in (1, 3, 16):
        blocks = rng.integers(0, 256, (rs_dims, 120), dtype=np.uint8)
        interleaved = blocks.T.reshape(-1)   # p[j + k*rs_dims]
        out = native.rs_deinterleave(interleaved, rs_dims)
        assert np.array_equal(out, blocks)
        assert np.array_equal(out, JN.rs_deinterleave(interleaved, rs_dims))


def test_plain_fallbacks_equal_native():
    if not native.have_native():
        pytest.skip("no C++ compiler to build native/vitio.cpp")
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 3072, dtype=np.uint8)
    assert np.array_equal(native.encode(bits), native.encode_plain(bits))
    assert np.array_equal(native.pack_bits(bits),
                          native.pack_bits_plain(bits))
    mask = rng.integers(0, 2, 24, dtype=np.uint8)
    syms = rng.integers(0, 256, 3000, dtype=np.uint32)
    assert np.array_equal(native.depuncture(syms, mask, 4000),
                          native.depuncture_plain(syms, mask, 4000))
    p = rng.integers(0, 256, 48 * 120, dtype=np.uint8)
    assert np.array_equal(native.rs_deinterleave(p, 48),
                          native.rs_deinterleave_plain(p, 48))


def test_frame_ring_multithreaded(lib):
    """test_native.py::test_frame_ring_multithreaded: three producers,
    one consumer, every frame popped once with its tag."""
    ring = native.FrameRing(capacity=8, frame_len=4)
    produced, popped = [], []

    def producer(base):
        for i in range(10):
            ring.push(np.full(4, base + i, dtype=np.uint32), tag=base + i)
            produced.append(base + i)

    def consumer():
        while len(popped) < 30:
            frames, tags = ring.pop_batch(8, min_batch=1)
            if frames.shape[0] == 0:
                break
            for f, t in zip(frames, tags):
                assert (f == t).all()
                popped.append(int(t))

    ct = threading.Thread(target=consumer)
    ct.start()
    threads = [threading.Thread(target=producer, args=(100 * k,))
               for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    ct.join(timeout=10)
    assert not ct.is_alive() and not any(t.is_alive() for t in threads)
    assert sorted(popped) == sorted(produced)
    ring.close()
    with pytest.raises(ValueError, match="frame of 3 words"):
        ring.push(np.zeros(3, np.uint32))


def test_frame_ring_close_releases_a_waiting_consumer(lib):
    ring = native.FrameRing(capacity=2, frame_len=2)
    got = []
    t = threading.Thread(target=lambda: got.append(ring.pop_batch(4, 2)))
    t.start()
    ring.push(np.ones(2, np.uint32), tag=5)
    ring.close()
    t.join(timeout=10)
    assert not t.is_alive()
    frames, tags = got[0]
    assert frames.shape[0] <= 1 and list(tags) in ([], [5])
    assert not ring.push(np.ones(2, np.uint32))


def _batches(framebits, n=5, B=3, seed=0):
    rng = np.random.default_rng(seed)
    return [np.stack([golden.hard_to_soft(golden.encode(b))
                      for b in rng.integers(0, 2, (B, framebits),
                                            dtype=np.uint8)]).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 3, 8])
def test_pipelined_decode_matches_sequential_and_jax(depth):
    """test_native.py::test_pipelined_decode_matches_sequential: results
    in order, equal to one call at a time and to the JAX pipeline."""
    jax, JG, JN, JP, JC, jacs, jtb = _jax()
    framebits = 48
    batches = _batches(framebits)

    def decode(s):
        decisions, _ = acs.forward(s, framebits + 6)
        return tb.chainback_scan(decisions, framebits)

    @jax.jit
    def jdecode(s):
        decisions, _ = jacs.forward(s, framebits + JC.TAIL_BITS)
        return jtb.chainback_scan(decisions, framebits)

    want = [decode(torch.from_numpy(b)).numpy() for b in batches]
    got = list(pipeline.decode_pipelined(batches, decode, depth=depth,
                                         device="cpu"))
    jgot = list(JP.decode_pipelined(batches, jdecode, depth=depth))
    assert len(got) == len(want) == len(jgot)
    for g, w, j in zip(got, want, jgot):
        assert isinstance(g, np.ndarray)
        assert np.array_equal(g, w) and np.array_equal(g, j)


def test_pipelined_decode_calls_in_order_and_validates():
    seen = []

    def record(t):
        seen.append(int(t[0]))
        return t * 2

    batches = [np.full(3, i, np.int64) for i in range(7)]
    out = list(pipeline.decode_pipelined(iter(batches), record, depth=3,
                                         device="cpu"))
    assert seen == list(range(7))
    assert [int(o[0]) for o in out] == [2 * i for i in range(7)]
    assert list(pipeline.decode_pipelined([], record, device="cpu")) == []
    with pytest.raises(ValueError, match="depth"):
        next(pipeline.decode_pipelined(batches, record, depth=0))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_card_pipelined_matches_serial(cuda, depth):
    """Packed batches through kernels A and B with ``depth`` in flight,
    varying shapes included: equal to one call at a time."""
    rng = np.random.default_rng(depth)
    batches = [acs_cuda.pack_symbols_host(
        rng.integers(0, 256, (B, 4 * 774), dtype=np.int32))
        for B in (64, 64, 100, 64, 1, 64)]

    def decode(t):
        return acs_cuda.decode(t, 768, packed="bt")

    want = [decode(torch.from_numpy(b).to(cuda)).cpu().numpy()
            for b in batches]
    got = list(pipeline.decode_pipelined(batches, decode, depth=depth))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert len(got) == len(want)
