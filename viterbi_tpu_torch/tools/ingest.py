"""Host ingest, recorded: the twin of ``scripts/ingest_bench.py``
(``INGEST_TPU.json``, whose keys it keeps). Writes ``INGEST_GPU.json``.

Three figures at the production batch (8192 frames of 3072 bits, packed
words, ``acs_cuda.decode``: kernels A and B):

  1. device only: the words resident, device ms of a call (the ceiling);
  2. with ingest: every batch packed on the host (a byte reinterpret) and
     copied to the card before its decode, ``utils.pipeline.
     decode_pipelined`` keeping ``depth`` batches in flight: ms a batch;
  3. the native frame ring (``utils.native.FrameRing``) fed one frame a
     call by four producer threads and drained in batches: frames/s.

Beside them the host's packing and the pageable copy alone, and the
pipelined feed against one pageable call at a time, in turns (serial,
depth 1, depth 2, depth 2, depth 1, serial, ``rounds`` times): the median
and the range of each, since single runs spread by tens of per cent.

``native_checks``, ``ring`` and ``turns`` are the measurement's parts;
``chip_smoke.py`` phase 16 calls them at its own shapes.

Usage: python -m viterbi_tpu_torch.tools.ingest [--device cpu]
       [--out PATH]
"""

from __future__ import annotations

import statistics
import sys
import threading
import time

import numpy as np
import torch

from .. import constants as C
from .. import golden
from ..runtime.placement import strict_device
from . import _record

FRAMEBITS = 3072
BATCH = 8192
NBATCHES = 12
DEPTH = 2
RING_FRAMES = 20000
PRODUCERS = 4
ROUNDS = 4


def native_checks(seed: int = 16, framebits: int = FRAMEBITS) -> str:
    """Build ``libvitio.so`` and hold each function against its numpy
    fall-back; returns the library's path. Raises if it did not build or
    differs."""
    from ..utils import native
    if not native.have_native():
        raise RuntimeError("libvitio.so did not build")
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, framebits, dtype=np.uint8)
    mask = rng.integers(0, 2, 32, dtype=np.uint8)
    syms = rng.integers(0, 256, 4 * framebits, dtype=np.uint32)
    p = rng.integers(0, 256, 16 * C.RS_N, dtype=np.uint8)
    pairs = ((native.encode(bits), native.encode_plain(bits)),
             (native.pack_bits(bits), native.pack_bits_plain(bits)),
             (native.depuncture(syms, mask, 6 * framebits),
              native.depuncture_plain(syms, mask, 6 * framebits)),
             (native.rs_deinterleave(p, 16),
              native.rs_deinterleave_plain(p, 16)))
    for i, (got, want) in enumerate(pairs):
        if not np.array_equal(got, want):
            raise AssertionError(f"libvitio function {i} != its numpy "
                                 f"fall-back")
    return str(native.library_path())


def ring(frames: np.ndarray, count: int, producers: int = PRODUCERS):
    """``count`` frames (frame ``i`` is ``frames[i % len(frames)]``, uint32
    rows) pushed one a call, tagged, by ``producers`` threads into a
    ``FrameRing`` and drained in batches of up to 256, each popped frame
    held against what was pushed. Returns the seconds it took."""
    from ..utils import native
    r = native.FrameRing(capacity=1024, frame_len=frames.shape[1])
    failed, popped = [], 0

    def produce(first):
        try:
            for i in range(first, count, producers):
                if not r.push(frames[i % len(frames)], tag=i):
                    raise RuntimeError("ring closed")
        except BaseException as e:     # reported below; the ring closes
            failed.append(e)           # so that the consumer stops
            r.close()
            raise

    t0 = time.perf_counter()
    threads = [threading.Thread(target=produce, args=(k,))
               for k in range(producers)]
    for t in threads:
        t.start()
    try:
        while popped < count:
            got, tags = r.pop_batch(256, min_batch=1)
            if got.shape[0] == 0:
                break
            if not np.array_equal(got, frames[tags % len(frames)]):
                raise AssertionError("ring frames != pushed")
            popped += got.shape[0]
    finally:
        secs = time.perf_counter() - t0
        r.close()
        for t in threads:
            t.join(timeout=60)
    if failed or any(t.is_alive() for t in threads):
        raise RuntimeError(f"ring producers failed: {failed}")
    if popped != count:
        raise AssertionError(f"{popped} of {count} frames through the ring")
    return secs


def turns(batches, decode, dev, rounds: int = ROUNDS):
    """``decode_pipelined`` over ``batches`` at depth 1 and 2 against one
    pageable call at a time, in turns, ``rounds`` times; every run's
    output equal to the first serial run's. Returns (ms a run by side,
    the launches of a pipelined run, the same in every one)."""
    from ..utils import pipeline

    def serial_run():
        return [decode(torch.from_numpy(b).to(dev)).cpu().numpy()
                for b in batches]

    serial = serial_run()
    # pin the two staging buffers once, as a feed that runs on does
    list(pipeline.decode_pipelined(batches[:2], decode, depth=2,
                                   device=dev))
    secs = {"serial": [], "depth 1": [], "depth 2": []}
    launches = []
    for side in ("serial", 1, 2, 2, 1, "serial") * rounds:
        _record.zero_launches()
        t0 = time.perf_counter()
        got = serial_run() if side == "serial" else list(
            pipeline.decode_pipelined(batches, decode, depth=side,
                                      device=dev))
        name = side if side == "serial" else f"depth {side}"
        secs[name].append(1e3 * (time.perf_counter() - t0))
        if len(got) != len(serial) or not all(
                np.array_equal(g, s) for g, s in zip(got, serial)):
            raise AssertionError(f"{name} != one call at a time")
        if side != "serial":
            launches.append(_record.launches())
    if any(n != launches[0] for n in launches):
        raise AssertionError(f"pipelined runs launched differently: "
                             f"{launches}")
    return secs, launches[0]


def spread(ms: list) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "runs": ms}


def run(device=None, framebits: int = FRAMEBITS, batch: int = BATCH,
        nbatches: int = NBATCHES, depth: int = DEPTH,
        ring_frames: int = RING_FRAMES, producers: int = PRODUCERS,
        rounds: int = ROUNDS) -> dict:
    from ..ops import acs_cuda
    from ..utils import pipeline
    dev = strict_device(device)
    lib = native_checks(framebits=framebits)
    nsteps = framebits + C.TAIL_BITS
    rng = np.random.default_rng(0)
    frames_u8 = rng.integers(0, 256, (batch, C.RATE * nsteps),
                             dtype=np.uint8)
    packed = acs_cuda.pack_symbols_host(frames_u8)

    def decode(t):
        return acs_cuda.decode(t, framebits, packed="bt")

    # 1. device only
    dev_in = torch.from_numpy(packed).to(dev)
    head = decode(dev_in)[:2].cpu().numpy()
    bad = int((head != golden.deconvolve_many(
        framebits, frames_u8[:2].astype(np.int32))).any(axis=1).sum())
    dev_ms = _record.device_ms(lambda: decode(dev_in), dev, nbatches)
    del dev_in
    # the host's packing, and the pageable copy, alone
    t0 = time.perf_counter()
    for _ in range(nbatches):
        words = acs_cuda.pack_symbols_host(frames_u8)
    pack_ms = 1e3 * (time.perf_counter() - t0) / nbatches
    t0 = time.perf_counter()
    for _ in range(nbatches):
        copied = torch.from_numpy(words).to(dev)
    _record.sync(dev)
    put_ms = 1e3 * (time.perf_counter() - t0) / nbatches
    del copied
    # 2. with ingest: pack, copy, decode, depth batches in flight
    list(pipeline.decode_pipelined([packed] * depth, decode, depth=depth,
                                   device=dev))          # pins the staging
    _record.zero_launches()
    t0 = time.perf_counter()
    n_out = sum(1 for _ in pipeline.decode_pipelined(
        (acs_cuda.pack_symbols_host(frames_u8) for _ in range(nbatches)),
        decode, depth=depth, device=dev))
    e2e_ms = 1e3 * (time.perf_counter() - t0) / n_out
    counts = _record.launches()
    # 3. the frame ring
    ring_fps = ring_frames / ring(packed.view(np.uint32), ring_frames,
                                  producers)
    # the feed against one pageable call at a time, in turns
    batches = [np.roll(packed, k * (batch // 8), axis=0) for k in range(8)]
    secs, _ = turns(batches, decode, dev, rounds)
    nsym = batch * C.RATE * nsteps
    fps = batch / (e2e_ms / 1e3)
    lost = (_record.missing(counts, ("acs_regs", "tb_walk"))
            if dev.type == "cuda" else [])
    return dict(
        device=_record.stamp(dev), framebits=framebits, batch=batch,
        nbatches=nbatches, depth=depth, native_ring=True, native_lib=lib,
        device_only_ms=dev_ms, host_pack_ms=pack_ms, device_put_ms=put_ms,
        e2e_with_ingest_ms=e2e_ms, device_only_gsym_s=nsym / dev_ms / 1e6,
        e2e_with_ingest_gsym_s=nsym / e2e_ms / 1e6,
        ingest_efficiency=dev_ms / e2e_ms, decode_frames_per_s=fps,
        ring_push_pop_frames_per_s=ring_fps, ring_producers=producers,
        ring_frame_words=int(packed.shape[1]),
        ring_keeps_up=bool(ring_fps >= fps),
        bottleneck=("device" if e2e_ms <= dev_ms * 1.05
                    else "host ingest (pack + copy)"),
        feed_ms_for_8_batches={k: spread(v) for k, v in secs.items()},
        launches=counts, mismatch_frames=bad, kernels_not_launched=lost,
        ok=bad == 0 and not lost,
        note=("device_only_ms: CUDA events, mean of nbatches calls on "
              "resident words; e2e: the pipelined feed's wall ms a batch; "
              "the ring carries packed words (one uint32 a step), one frame "
              "a push from each of its producer threads"))


def main(argv=None) -> int:
    args = _record.parser(__doc__).parse_args(argv)
    return _record.finish(run(args.device), args.out, "INGEST")


if __name__ == "__main__":
    sys.exit(main())
