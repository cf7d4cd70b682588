"""Chunked arrival, recorded: the twin of ``scripts/session_bench.py``
(``SESSION_TPU.json``). Writes ``SESSION_GPU.json``.

``parallel.StreamSession`` on 64 parallel 128 kbit/s streams of 3072-bit
logical frames, pushed in chunks of 1, 5 and 32 frames (40, 40 and 192
frames a stream), then flushed:

  * the concatenation of every push's and the flush's bytes against the
    one-shot decode of the whole stream through kernels A and B;
  * each push's wall time (the symbols arrive as host bytes, the bytes go
    back to the host), p50 and max of the pushes after the first, against
    the receiver's budget of 24 ms a frame; the flush's;
  * the emitted-bit lag: after each push that emitted, the bits that have
    arrived but not been emitted (the overlap plus the rounding of the
    emit boundary to 24 bits); after every push, that no push held back
    more than that, and whether every push emitted (it must where a
    chunk is longer than the overlap, as at these shapes);
  * on a card, the launches a push (kernel A twice, kernel B once) and the
    device ms of the last push's launches, each alone.

``stream`` and ``chunks`` are one such measurement; ``chip_smoke.py``
phase 15 calls them at its own shapes.

Usage: python -m viterbi_tpu_torch.tools.session [--device cpu]
       [--out PATH]
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from .. import constants as C
from ..harness import channel
from ..runtime.placement import strict_device
from . import _record

FRAMEBITS = 3072
STREAMS = 64
CHUNKS = (1, 5, 32)          # frames a push
FRAME_MS = 24.0
ITERS = 5


def stream(dev, streams: int, frames: int, framebits: int, seed: int):
    """``streams`` noisy terminated streams of ``frames`` frames, made on
    ``dev``: (data symbols uint8[B, 4 * bits] and tail symbols uint8[B,
    24] on the host, as they arrive; the one-shot decode through kernels
    A and B, bytes on the host)."""
    from ..ops import acs_cuda
    sb = frames * framebits
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(0, 2, (streams, sb), generator=gen, device=dev)
    syms = channel.soft_on_device(bits, False, gen)
    whole = acs_cuda.decode(syms, sb).cpu().numpy()
    host = syms.to(torch.uint8).cpu().numpy()
    return host[:, :C.RATE * sb], host[:, C.RATE * sb:], whole


def chunks(dev, data, tail, whole, chunk_frames: int, framebits: int,
           hold=None, iters: int = ITERS) -> dict:
    """Push ``data`` in chunks of ``chunk_frames`` frames into a
    ``StreamSession`` on ``dev``, then flush ``tail``. ``hold(fwd,
    walk)``, if given, gets the last push's recorded ``forward_regs`` and
    ``tb_walk_bytes`` calls while their tensors live."""
    from ..ops import acs_cuda
    from ..ops import traceback as tb
    from ..parallel import StreamSession
    from ..parallel.session import EMIT_QUANTUM
    B = data.shape[0]
    step = C.RATE * framebits * chunk_frames
    n = data.shape[1] // step
    sess = StreamSession(B, device=dev)
    outs, secs, lags, unemitted = [], [], [], []

    def push(i):
        t0 = time.perf_counter()
        outs.append(sess.push(data[:, i * step:(i + 1) * step]))
        secs.append(time.perf_counter() - t0)
        unemitted.append((i + 1) * framebits * chunk_frames
                         - sess.emitted_bits)
        if sess.emitted_bits:
            lags.append(unemitted[-1])

    _record.zero_launches()
    for i in range(n - 1):
        push(i)
    counts = _record.launches()
    with _record.recorded(acs_cuda, "forward_regs") as fwd, \
            _record.recorded(tb, "tb_walk_bytes") as walk:
        push(n - 1)
    rec = dict(frames_per_stream=n * chunk_frames, n_pushes=n,
               chunk_ms_realtime_budget=FRAME_MS * chunk_frames,
               first_push_ms=1e3 * secs[0])
    steady = [1e3 * s for s in secs[1:]] or [1e3 * secs[0]]
    rec.update(push_ms_p50=statistics.median(steady),
               push_ms_max=max(steady),
               emit_lag_bits_max=max(lags), emit_lag_bits_min=min(lags),
               every_push_emitted=all(o.shape[1] > 0 for o in outs),
               unemitted_bits_max=max(unemitted))
    # no push holds back more than the overlap and the emit rounding: a
    # session that kept its output for the flush fails here
    rec["none_held_back"] = rec["unemitted_bits_max"] < \
        sess.overlap + EMIT_QUANTUM
    if sess.use_kernels:
        pushes = max(n - 1, 1)
        rec["launches_per_push"] = {k: v / pushes for k, v in counts.items()}
        rec["launches_ok"] = _record.only(
            {"acs_regs": 2 * pushes, "tb_walk": pushes}, counts)
        if hold is not None:
            hold(fwd, walk)
        (a, akw, _), (b, bkw, _) = fwd
        wargs, wkw, _ = walk[0]
        rec["last_push_parts_ms"] = {
            "A emit": _record.device_ms(
                lambda: acs_cuda.forward_regs(*a, **akw), dev, iters),
            "A look-ahead": _record.device_ms(
                lambda: acs_cuda.forward_regs(*b, **bkw), dev, iters),
            "B": _record.device_ms(
                lambda: tb.tb_walk_bytes(*wargs, **wkw), dev, iters)}
        del fwd, walk, a, b, wargs
    t0 = time.perf_counter()
    outs.append(sess.flush(tail))
    rec["flush_ms"] = 1e3 * (time.perf_counter() - t0)
    rec["match_one_shot"] = bool(np.array_equal(
        np.concatenate(outs, axis=1), whole))
    rec["ok"] = rec["match_one_shot"] and rec["none_held_back"] and \
        rec.get("launches_ok", True)
    return rec


def run(device=None, streams: int = STREAMS, chunk_sizes=CHUNKS,
        framebits: int = FRAMEBITS, min_frames: int = 40) -> dict:
    dev = strict_device(device)
    doc = {"device": _record.stamp(dev), "framebits": framebits,
           "batch": streams, "chunks": {}}
    for c in chunk_sizes:
        frames = max(min_frames, 6 * c)
        data, tail, whole = stream(dev, streams, frames, framebits, 99 + c)
        rec = doc["chunks"][str(c)] = chunks(dev, data, tail, whole, c,
                                             framebits)
        print(f"chunk {c} frames: match {rec['match_one_shot']}, push p50 "
              f"{rec['push_ms_p50']:.3f} ms, max {rec['push_ms_max']:.3f} "
              f"against {rec['chunk_ms_realtime_budget']} ms, lag "
              f"{rec['emit_lag_bits_max']} bits", flush=True)
    doc["ok"] = all(r["ok"] for r in doc["chunks"].values())
    return doc


def main(argv=None) -> int:
    args = _record.parser(__doc__).parse_args(argv)
    return _record.finish(run(args.device), args.out, "SESSION")


if __name__ == "__main__":
    sys.exit(main())
