"""Overlap sweep, the twin of ``scripts/overlap_sweep.py``
(``OVERLAP_SWEEP.json``, which justifies ``parallel.streaming.
DEFAULT_OVERLAP``). Writes ``OVERLAP_SWEEP_GPU.json``.

Block-overlap streaming's one approximation is the truncated walk: each
block anchors its walk at the best state ``overlap`` steps past its end.
The sweep decodes identical noisy streams (``harness.channel.make_frames``,
the JAX package's draws) block-overlapped and whole, and counts the bits
and the frames that differ per (Eb/N0, seed, overlap, warm-up), down to 0
dB where survivors merge slowest. The streams go through
``make_local_stream_decoder(n_blocks=n_seq)``, bit-equal to the ring of
``n_seq`` ranks; the reference is the whole-stream decode through kernels
A and B.

Two forms. The plain form (``use_kernels=False``) runs at the requested
overlap and warm-up, so its counts must equal ``OVERLAP_SWEEP.json``'s
``cells`` where the settings are the same; at the record's n_seq, block
bits and batch (the defaults) every plain cell must find its cell there.
The kernel form (kernels A and B; their plain versions on the CPU)
rounds the overlap to 6 (mod ckpt) and the warm-up down to a multiple of
ckpt (ckpt 18 at 3072-bit blocks: overlaps 8 ... 120 run as 24, 24, 24,
42, 60, 78, 96, 132): each of its cells records both and must equal, bit
for bit, the plain form run at its effective overlap and warm-up. On a
card the kernel form must launch kernels A and B (``launches``).

Usage: python -m viterbi_tpu_torch.tools.overlap_sweep [--device cpu]
       [--out PATH]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .. import constants as C
from ..harness import channel
from ..ops import acs_cuda
from ..parallel import streaming
from ..runtime.placement import strict_device
from . import _record

OVERLAPS = (8, 16, 24, 36, 48, 70, 96, 120)
EBN0_DB = (3.0, 1.5, 0.0)
WARMUPS = (16, 32, 64, 256)
N_SEQ, BLOCK_BITS, BATCH, SEEDS = 8, 3072, 64, 2
REFERENCE = _record.ROOT / "OVERLAP_SWEEP.json"


def effective(blk: int, overlap: int, warmup: int) -> tuple[int, int]:
    """The kernel form's (overlap, warm-up) for a requested pair."""
    ov, warm, _ = streaming._plan_block_layout(blk, overlap, warmup, True)
    return ov, warm


def _kernel_form(dev, stream_bits: int, n_seq: int, overlap: int,
                 warmup: int):
    """The kernel form of the local decoder: on a card through
    ``make_local_stream_decoder``; on the CPU, where that entry point
    takes the plain form, through ``streaming.decode_kernels``, which runs
    the kernels' plain versions."""
    if dev.type == "cuda":
        return streaming.make_local_stream_decoder(
            stream_bits, n_seq, overlap=overlap, use_kernels=True,
            warmup=warmup, device=dev)
    blk = stream_bits // n_seq
    plan = streaming._plan_block_layout(blk, overlap, warmup, True)
    return lambda d, t: streaming.decode_kernels(d, t, n_seq, blk, *plan)


def _count(out: torch.Tensor, ref: torch.Tensor) -> dict:
    diff = (out ^ ref).cpu().numpy()
    return dict(mismatch_bits=int(np.unpackbits(diff).sum()),
                mismatch_frames=int(diff.any(axis=1).sum()))


def _reference_cells(n_seq, blk, batch) -> dict | None:
    """``OVERLAP_SWEEP.json``'s cells by (Eb/N0, seed, overlap, warm-up),
    where its settings are these; else None."""
    if not REFERENCE.exists():
        return None
    ref = json.loads(REFERENCE.read_text())
    if (ref["n_seq"], ref["block_bits"], ref["batch"]) != (n_seq, blk,
                                                           batch):
        return None
    return {(c["ebn0_db"], c["seed"], c["overlap"], c["warmup"]): c
            for c in ref["cells"]}


def run(device=None, n_seq: int = N_SEQ, block_bits: int = BLOCK_BITS,
        batch: int = BATCH, seeds=range(SEEDS), ebn0s=EBN0_DB,
        overlaps=OVERLAPS, warmups=WARMUPS,
        warmup_overlap: int = streaming.DEFAULT_OVERLAP) -> dict:
    """The sweep. ``seeds`` and ``ebn0s`` pick the streams, ``overlaps``
    run at the default warm-up and ``warmups`` at ``warmup_overlap``."""
    dev = strict_device(device)
    stream_bits = block_bits * n_seq
    wanted = [(ov, streaming.WARMUP_STEPS) for ov in overlaps] + \
        [(warmup_overlap, w) for w in warmups]
    known = _reference_cells(n_seq, block_bits, batch)
    plain_cells, kernel_cells = [], []
    kernel_launches = dict.fromkeys(_record.KERNELS, 0)
    for ebn0 in ebn0s:
        for seed in seeds:
            _, syms = channel.make_frames(batch, stream_bits, seed=seed,
                                          ebn0_db=ebn0)
            x = torch.from_numpy(syms.astype(np.int32)).to(dev)
            data, tail = x[:, :C.RATE * stream_bits], x[:, C.RATE *
                                                         stream_bits:]
            ref = acs_cuda.decode(x, stream_bits)
            plain = {}

            def plain_out(ov, w):
                if (ov, w) not in plain:
                    plain[(ov, w)] = streaming.make_local_stream_decoder(
                        stream_bits, n_seq, overlap=ov, use_kernels=False,
                        warmup=w, device=dev)(data, tail)
                return plain[(ov, w)]

            key = dict(ebn0_db=ebn0, seed=seed, frames=batch,
                       stream_bits=stream_bits)
            for ov, w in wanted:
                t0 = time.perf_counter()
                cell = dict(key, overlap=ov, warmup=w,
                            **_count(plain_out(ov, w), ref))
                cell["secs"] = time.perf_counter() - t0
                was = known and known.get((ebn0, seed, ov, w))
                if was:
                    cell["equal_to_reference"] = all(
                        cell[k] == was[k] for k in ("mismatch_bits",
                                                    "mismatch_frames"))
                plain_cells.append(cell)
            for ov, w in wanted:
                eov, ew = effective(block_bits, ov, w)
                t0 = time.perf_counter()
                _record.zero_launches()
                out = _kernel_form(dev, stream_bits, n_seq, ov, w)(data,
                                                                   tail)
                _record.sync(dev)
                secs = time.perf_counter() - t0
                for k, v in _record.launches().items():
                    kernel_launches[k] += v
                kernel_cells.append(dict(
                    key, overlap=ov, warmup=w, effective_overlap=eov,
                    effective_warmup=ew, **_count(out, ref),
                    equal_to_plain_at_effective=bool(torch.equal(
                        out, plain_out(eov, ew))), secs=secs))
            last = slice(-len(wanted), None)
            frames = [[c["mismatch_frames"] for c in cells[last]]
                      for cells in (plain_cells, kernel_cells)]
            print(f"Eb/N0 {ebn0} dB seed {seed}: mismatch frames, plain "
                  f"{frames[0]}, kernel {frames[1]}", flush=True)
    against = [c for c in plain_cells if "equal_to_reference" in c]
    at_reference = (n_seq, block_bits, batch) == (N_SEQ, BLOCK_BITS, BATCH)
    doc = dict(
        device=_record.stamp(dev), n_seq=n_seq, block_bits=block_bits,
        batch=batch, seeds=list(seeds), ebn0_db=list(ebn0s),
        default_overlap=streaming.DEFAULT_OVERLAP,
        warmup_steps=streaming.WARMUP_STEPS,
        overlap_rounding={str(ov): effective(block_bits, ov,
                                             streaming.WARMUP_STEPS)[0]
                          for ov in overlaps},
        plain_cells=plain_cells, kernel_cells=kernel_cells,
        at_reference_settings=at_reference,
        reference_cells_compared=len(against),
        reference_cells_differing=sum(not c["equal_to_reference"]
                                      for c in against),
        kernel_cells_differing=sum(not c["equal_to_plain_at_effective"]
                                   for c in kernel_cells),
        launches=kernel_launches,
        kernels_not_launched=(_record.missing(kernel_launches,
                                              ("acs_regs", "tb_walk"))
                              if dev.type == "cuda" else []),
        note=("plain form at the requested overlap and warm-up, against "
              "OVERLAP_SWEEP.json's cells where the settings match; kernel "
              "form at the effective ones, against the plain form there; "
              "mismatch counts against the whole-stream decode through "
              "kernels A and B; at OVERLAP_SWEEP.json's n_seq, block_bits "
              "and batch every plain cell must be compared; launches: the "
              "kernel form's"))
    # at the record's settings every plain cell is held against it: a
    # missing record or cell fails the sweep
    doc["ok"] = (doc["reference_cells_differing"] == 0
                 and doc["kernel_cells_differing"] == 0
                 and (not at_reference or len(against) == len(plain_cells))
                 and not doc["kernels_not_launched"])
    return doc


def main(argv=None) -> int:
    args = _record.parser(__doc__).parse_args(argv)
    return _record.finish(run(args.device), args.out, "OVERLAP_SWEEP")


if __name__ == "__main__":
    sys.exit(main())
