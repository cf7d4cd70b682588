"""Batch sweeps of the decode kernels. ``sweep``: kernel A (fused
register-exchange ACS, ``acs_cuda.forward_regs``) and kernel C (decisions,
``acs_cuda.forward``) over the batch, at one frame size, packed
frame-major symbols; then the other symbol layouts at the shapes the
decode paths use, the block-size rows that tell several warps on one SM
from several SMs, and the SM clock that ``nvidia-smi`` reads while kernel A
runs at a small, a middle and a large batch (a card lowers its clock as
more of it is busy, which the same kernel then shows as time).
``sweep_small``: kernel A alone from one frame to a few thousand, at
768 and 3072 bits, each form by name and the wrapper's choice, in a
replayed CUDA graph: where its forms cross at small batches.
``sweep_walk``: kernel B (the checkpoint walk, ``traceback.tb_walk``) over
the batch at several frame sizes, alone and with the byte assembly behind
it (``traceback.chainback_regs_cuda``), on kernel A's checkpoints of noisy
frames; where the wrapper takes ``segments`` (the lanes a frame), each
form by itself too.

Where the wrappers take ``lanes`` (the kernels' forms, one lane a frame
or several; kernel A also a whole warp a frame), the batch rows also time
each form by itself: the wrapper's own choice by batch should follow the
faster one.

The wrappers' interface is the same in every version of the port, so the
same script times another checkout of it: ``--root DIR`` imports
``viterbi_tpu_torch`` from DIR. Run it as a file for that,

    python viterbi_tpu_torch/probes/kbatch.py --root build/parent

and compare two versions only within one run of the card (this one, then
the other, then again). Without ``--root``:
``python -m viterbi_tpu_torch.probes.kbatch``.

Usage: kbatch.py [--root DIR] [--what forward|small|walk|all]
                 [--framebits N] [--iters N] [--json PATH]
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

if __package__:
    from ._common import card_line, graph_ms
else:
    # run as a file: the script's own directory is first on the path
    from _common import card_line, graph_ms

BATCHES = (1, 64, 1024, 4096, 10240, 16384, 24576, 32768, 65536)
CLOCK_BATCHES = (32, 1024, 16384)   # SM clock read under each of these loads
CHAIN_BATCH = 10240     # frames of 2048 superframes: unpacked symbols
MAIN_BATCH = 16384      # the main path's batch
BLOCK_BATCH = 128       # four warps of one-frame threads, or 16 of lanes
SMALL_BATCHES = (1, 2, 5, 8, 16, 40, 64, 128, 256, 512, 1024, 1536, 1600,
                 2048, 2560, 3072, 3200, 4096)   # kernel A's small sweep
SMALL_FRAMEBITS = (768, 3072)
WALK_FRAMEBITS = (3072, 192, 9216)   # kernel B's sweep: K = 129, 9, 385
WALK_SEGMENTS = (1, 4, 8, 16, 32)    # kernel B's forms, timed by name
EBN0_DB = 3.0           # the noisy frames of kernel B's sweep


def _sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def _median_ms(torch, fn, iters: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean device time of ``iters``
    back-to-back runs (CUDA events), after one untimed run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def sweep(acs_cuda, framebits: int = 3072, iters: int = 5,
          batches=BATCHES) -> dict:
    """Times in ms of kernels A and C; returns {"batch": {B: {"A": ms,
    "C": ms, and "A, n lane(s)", "C, n lane(s)" for each form}},
    "layouts": {...}, "blocks": {...}, "clock_mhz": {B: MHz}}."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("this probe times CUDA kernels and needs a CUDA "
                           "device")
    dev = torch.device("cuda", torch.cuda.current_device())
    nsteps = framebits + 6
    ck = acs_cuda.DECODE_CKPT
    gen = torch.Generator(device=dev).manual_seed(0)

    def words(batch):
        return torch.randint(-2**31, 2**31, (batch, nsteps), device=dev,
                             dtype=torch.int64, generator=gen) \
            .to(torch.int32)

    def both(syms, packed, c=True, **kw):
        row = {"A": _median_ms(torch, lambda: acs_cuda.forward_regs(
            syms, nsteps, ckpt=ck, packed=packed, **kw), iters)}
        if c:
            row["C"] = _median_ms(torch, lambda: acs_cuda.forward(
                syms, nsteps, packed=packed, **kw), iters)
        return row

    forms = regs_forms(acs_cuda)
    out = {"batch": {}, "layouts": {}, "blocks": {}}
    for batch in batches:
        w = words(batch)
        row = both(w, "bt")
        for lanes in forms:
            # kernel C has no warp-wide form
            form = both(w, "bt", c=lanes in (1, acs_cuda.LANES), lanes=lanes)
            row.update({f"{k}, {lanes} lane(s)": v for k, v in form.items()})
        out["batch"][batch] = row
        del w
        torch.cuda.empty_cache()
    # the chain's shape: unpacked int32 symbols [B, 4 * nsteps]
    w = words(CHAIN_BATCH)
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=dev)
    unpacked = ((w[..., None] >> shifts) & 255).reshape(CHAIN_BATCH, -1) \
        .contiguous()
    out["layouts"][f"unpacked B={CHAIN_BATCH}"] = both(unpacked, False)
    del unpacked
    # the same frames frame-major and time-major at the main path's batch
    w = words(MAIN_BATCH)
    out["layouts"][f"packed bt B={MAIN_BATCH}"] = both(w, "bt")
    out["layouts"][f"packed time-major B={MAIN_BATCH}"] = both(
        w.T.contiguous(), True)
    # one block on one SM against the same frames on several SMs
    w = words(BLOCK_BATCH)
    keep = acs_cuda.ACS_THREADS, acs_cuda.WORDS_THREADS
    try:
        for threads in (32, 64, 128):
            acs_cuda.ACS_THREADS = acs_cuda.WORDS_THREADS = threads
            out["blocks"][f"B={BLOCK_BATCH}, {threads} threads a block"] = \
                both(w, "bt")
    finally:
        acs_cuda.ACS_THREADS, acs_cuda.WORDS_THREADS = keep
    # the SM clock while kernel A keeps the card busy for about a second
    out["clock_mhz"] = {}
    for batch in CLOCK_BATCHES:
        w = words(batch)
        # queue well over a second of work, then read while it runs
        for _ in range(3000 if batch < 4096 else 800):
            acs_cuda.forward_regs(w, nsteps, ckpt=ck, packed="bt")
        reads = [_sm_clock_mhz() for _ in range(3)]
        torch.cuda.synchronize()
        out["clock_mhz"][batch] = statistics.median(reads)
    return out


def regs_forms(acs_cuda) -> tuple:
    """Kernel A's forms by lanes a frame, where its wrapper names them."""
    if "lanes" not in inspect.signature(acs_cuda.forward_regs).parameters:
        return ()
    return (1, acs_cuda.LANES, *((acs_cuda.WARP_LANES,)
                                 if hasattr(acs_cuda, "WARP_LANES") else ()))


def sweep_small(acs_cuda, framebits=SMALL_FRAMEBITS,
                batches=SMALL_BATCHES) -> dict:
    """Kernel A's time in ms and in us a trellis step, in a replayed CUDA
    graph, at each batch: the wrapper's choice ("A") and each form by name
    ("A, n lane(s)"), on frame-major packed words at ckpt 24 (the bulk
    calls' layout), and at one frame also on unpacked int32 symbols (the
    live calls'); returns {framebits: {B: {...}}}."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("this probe times CUDA kernels and needs a CUDA "
                           "device")
    dev = torch.device("cuda", torch.cuda.current_device())
    ck = acs_cuda.DECODE_CKPT
    gen = torch.Generator(device=dev).manual_seed(2)
    forms = regs_forms(acs_cuda)
    out = {}
    for fb in framebits:
        nsteps = fb + 6
        out[fb] = {}
        for batch in batches:
            w = torch.randint(0, 2**31, (batch, nsteps), device=dev,
                              dtype=torch.int64, generator=gen) \
                .to(torch.int32)
            graphed = max(5, min(100, (1 << 24) // (batch * nsteps)))
            row = {}
            for lanes in (None, *forms):
                kw = {"lanes": lanes} if lanes else {}
                ms = graph_ms(lambda: acs_cuda.forward_regs(
                    w, nsteps, ckpt=ck, packed="bt", **kw), graphed)
                key = f"A, {lanes} lane(s)" if lanes else "A"
                row[key] = ms
            if batch == 1:
                unpacked = ((w[..., None].to(torch.int64)
                             >> torch.arange(0, 32, 8, device=dev)) & 255) \
                    .to(torch.int32).reshape(1, -1).contiguous()
                row["A, unpacked"] = graph_ms(lambda: acs_cuda.forward_regs(
                    unpacked, nsteps, ckpt=ck), graphed)
            row["us_per_step"] = {k: 1e3 * v / nsteps for k, v in row.items()}
            out[fb][batch] = row
            del w
        torch.cuda.empty_cache()
    return out


def noisy_frames(torch, constants, batch: int, nsteps: int, dev, gen):
    """Packed words int32[batch, nsteps] of random frames through the
    harness's encoder and channel (tail-terminated, offset 127.5, gain 32,
    AWGN at ``EBN0_DB`` for the rate-1/4 code), made on the card. The data
    must be random: the survivors of an all-zero frame sit in state 0, and
    kernel B's loads would coalesce as no real frame's do."""
    amp = (2.0 * 10.0 ** ((EBN0_DB - 10.0 * math.log10(4.0)) / 10.0)) ** 0.5
    tail = constants.TAIL_BITS
    bits = torch.randint(0, 2, (batch, nsteps + tail), device=dev,
                         dtype=torch.int32, generator=gen)
    bits[:, :tail] = 0
    bits[:, -tail:] = 0
    # the shift register at step t holds bits t-6..t, newest in bit 0
    sr = torch.zeros((batch, nsteps), dtype=torch.int32, device=dev)
    for i in range(constants.K):
        sr |= bits[:, tail - i: tail - i + nsteps] << i
    del bits
    parity = torch.tensor([bin(x).count("1") & 1 for x in range(128)],
                          dtype=torch.float32, device=dev)
    words = torch.zeros((batch, nsteps), dtype=torch.int32, device=dev)
    for q, poly in enumerate(constants.POLYS):
        mean = amp * (2.0 * parity[(sr & poly).long()] - 1.0)
        mean += torch.randn((batch, nsteps), device=dev, generator=gen)
        words |= (127.5 + 32.0 * mean).clamp_(0, 255).to(torch.int32) \
            << (8 * q)
        del mean
    return words


def sweep_walk(acs_cuda, tb, constants, framebits=WALK_FRAMEBITS,
               iters: int = 20, batches=BATCHES) -> dict:
    """Times in ms of kernel B on kernel A's checkpoints of noisy frames;
    returns {framebits: {B: {"B": the walk, "B + bytes": the walk and the
    byte assembly as ``chainback_regs_cuda`` runs them, "B, graph": the
    walk inside a replayed CUDA graph (device time without the host's
    launch cost), and where the wrapper names its forms "B + bytes, graph",
    "B, n segment(s), graph" for each and "B, then bytes" for the walk
    followed by ``_regs_bytes``}}}."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("this probe times CUDA kernels and needs a CUDA "
                           "device")
    dev = torch.device("cuda", torch.cuda.current_device())
    ck = acs_cuda.DECODE_CKPT
    gen = torch.Generator(device=dev).manual_seed(1)
    forms = WALK_SEGMENTS if "segments" in inspect.signature(
        tb.tb_walk).parameters else ()
    out = {}
    for fb in framebits:
        nsteps = fb + 6
        out[fb] = {}
        for batch in batches:
            w = noisy_frames(torch, constants, batch, nsteps, dev, gen)
            regs, _ = acs_cuda.forward_regs(w, nsteps, ckpt=ck, packed="bt")
            del w
            gap = nsteps - (regs.shape[0] - 1) * ck
            row = {"B": _median_ms(torch, lambda: tb.tb_walk(
                regs, ck, gap), iters),
                   "B + bytes": _median_ms(
                       torch, lambda: tb.chainback_regs_cuda(regs, fb,
                                                             ckpt=ck), iters)}
            graphed = max(10, min(200, (1 << 22) // (batch * nsteps)))
            row["B, graph"] = graph_ms(
                lambda: tb.tb_walk(regs, ck, gap), graphed)
            if forms:
                # (where the bytes are assembled by _regs_bytes, its index
                # tensors come from pageable host memory: not capturable)
                row["B + bytes, graph"] = graph_ms(
                    lambda: tb.chainback_regs_cuda(regs, fb, ckpt=ck),
                    graphed)
                row["B, then bytes"] = _median_ms(
                    torch, lambda: tb._regs_bytes(
                        tb.tb_walk(regs, ck, gap), fb, ck, gap), iters)
            for seg in forms:
                row[f"B, {seg} segment(s), graph"] = graph_ms(
                    lambda: tb.tb_walk(regs, ck, gap, segments=seg),
                    graphed)
            out[fb][batch] = row
            del regs
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", help="import viterbi_tpu_torch from this "
                                   "checkout instead of the one on the path")
    ap.add_argument("--what", choices=("forward", "small", "walk", "all"),
                    default="all", help="kernels A and C, kernel A at small "
                                        "batches, kernel B, or all three")
    ap.add_argument("--framebits", type=int, default=3072)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--json", help="also write the table to this file")
    args = ap.parse_args(argv)
    if args.root:
        if "viterbi_tpu_torch" in sys.modules:
            raise RuntimeError("--root needs the script run as a file, "
                               "before the package is imported")
        sys.path.insert(0, args.root)
    elif __package__ in (None, ""):
        # run as a file: this checkout's root is not on the path yet
        sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    acs_cuda = importlib.import_module("viterbi_tpu_torch.ops.acs_cuda")
    tb = importlib.import_module("viterbi_tpu_torch.ops.traceback")
    where = args.root or "this checkout"
    print(f"kbatch on {card_line()}: {where} "
          f"({acs_cuda.__file__}), framebits {args.framebits}, ckpt "
          f"{acs_cuda.DECODE_CKPT}, medians of 5 x {args.iters} launches")
    table = {}
    if args.what in ("forward", "all"):
        table = sweep(acs_cuda, args.framebits, args.iters)
        print("  SM clock while kernel A runs, MHz: " + ", ".join(
            f"B={b}: {mhz:.0f}" for b, mhz in table["clock_mhz"].items()))
        for section in ("batch", "layouts", "blocks"):
            for key, row in table[section].items():
                label = f"B={key} packed bt" if section == "batch" else key
                forms = "".join(f"   {k} {v:.3f}" for k, v in row.items()
                                if k not in ("A", "C"))
                print(f"  {label:38s} A {row['A']:8.3f} ms   C "
                      f"{row['C']:8.3f} ms{forms}")
    if args.what in ("small", "all"):
        table["small"] = sweep_small(acs_cuda)
        for fb, rows in table["small"].items():
            for batch, row in rows.items():
                print(f"  A framebits {fb:5d} B={batch:5d} ms: " + "   ".join(
                    f"{k} {v:.4f}" for k, v in row.items()
                    if k != "us_per_step")
                    + "   us a step: " + "   ".join(
                        f"{k} {v:.4f}" for k, v in row["us_per_step"].items()))
    if args.what in ("walk", "all"):
        constants = importlib.import_module("viterbi_tpu_torch.constants")
        table["walk"] = sweep_walk(acs_cuda, tb, constants,
                                   iters=4 * args.iters)
        for fb, rows in table["walk"].items():
            for batch, row in rows.items():
                print(f"  walk framebits {fb:5d} B={batch:6d} ms: "
                      + "   ".join(f"{k} {v:.4f}" for k, v in row.items()))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card_line(), "root": where, **table}, f,
                      indent=1)
    return table


if __name__ == "__main__":
    main()
