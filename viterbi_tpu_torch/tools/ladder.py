"""Resident decode rate of every DAB bitrate, the twin of
``scripts/ladder_bench.py`` (``LADDER_TPU.json``). Writes
``LADDER_GPU.json``.

The symbols lie on the device as packed words (one int32 a trellis step,
the ``deconvolve_batch(packed=True)`` layout) and ``acs_cuda.decode``
(kernels A and B, the ``cuda_fused`` rung) decodes them at B = 8192 and
32768 for 32 ... 384 kbit/s: the device time of a call (CUDA events, the
best of three rounds), Gsym/s (4 soft symbols a step) and the time a
thousand frame bits take. The reference's ideal is a time proportional to
the frame bits (viterbi-benchmark.cpp:16-24): the record gives the ratio
of the largest to the smallest time a frame bit at each batch. The first
two frames of every call are held against the golden model.

Memory at the largest cell, 32768 x 9216 bits: 1.2 GB of words and 3.2 GB
of checkpoints (385 x 64 x 32768 int32).

Usage: python -m viterbi_tpu_torch.tools.ladder [--batches 8192,32768]
       [--iters N] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import constants as C
from .. import golden
from ..runtime.placement import strict_device
from . import _record

BITRATES = (32, 64, 96, 128, 192, 384)
BATCHES = (8192, 32768)
ROUNDS = 3


def run(batches=BATCHES, iters: int = 20, device=None,
        bitrates=BITRATES, rounds: int = ROUNDS) -> dict:
    from ..ops import acs_cuda
    dev = strict_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    ladders, bad = {}, 0
    _record.zero_launches()
    for B in batches:
        rows = []
        for kbps in bitrates:
            fb = 24 * kbps
            nsteps = fb + C.TAIL_BITS
            # random words are random symbol bytes
            words = torch.randint(-2**31, 2**31, (B, nsteps), generator=gen,
                                  dtype=torch.int32, device=dev)

            def call():
                return acs_cuda.decode(words, fb, packed="bt")

            head = call()[:2].cpu().numpy()
            syms = words[:2].cpu().numpy().view(np.uint8).astype(np.int32)
            frame_bad = int((head != golden.deconvolve_many(fb, syms))
                            .any(axis=1).sum())
            bad += frame_bad
            ms = min(_record.device_ms(call, dev, iters)
                     for _ in range(rounds))
            nsym = B * C.RATE * nsteps
            rows.append(dict(
                kbps=kbps, framebits=fb, ckpt=acs_cuda.DECODE_CKPT,
                lanes=acs_cuda._lanes(B, acs_cuda.REGS_ONE_LANE_FRAMES,
                                      None),
                ms_per_batch=ms, gsym_s=nsym / ms / 1e6,
                us_per_kframebit=1e3 * ms / fb, mismatch_frames=frame_bad))
            print(B, rows[-1], flush=True)
            del words
        per_fb = [r["us_per_kframebit"] for r in rows]
        ladders[str(B)] = dict(
            rows=rows,
            time_per_framebit_ratio_maxmin=max(per_fb) / min(per_fb))
    _record.sync(dev)
    counts = _record.launches()
    lost = (_record.missing(counts, ("acs_regs", "tb_walk"))
            if dev.type == "cuda" else [])
    return dict(device=_record.stamp(dev), iters=iters, rounds=rounds,
                rung="cuda_fused", ladders=ladders, launches=counts,
                mismatch_frames=bad, kernels_not_launched=lost,
                ok=bad == 0 and not lost,
                note=("resident packed words, acs_cuda.decode (kernels A "
                      "and B); ms: mean device time of a call over iters "
                      "back-to-back calls, the best of rounds"))


def main(argv=None) -> int:
    ap = _record.parser(__doc__)
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    batches = tuple(int(b) for b in args.batches.split(","))
    return _record.finish(run(batches, args.iters, args.device), args.out,
                          "LADDER")


if __name__ == "__main__":
    sys.exit(main())
