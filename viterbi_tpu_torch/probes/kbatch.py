"""Batch sweep of the two forward kernels: kernel A (fused
register-exchange ACS, ``acs_cuda.forward_regs``) and kernel C (decisions,
``acs_cuda.forward``) over the batch, at one frame size, packed
frame-major symbols; then the other symbol layouts at the shapes the
decode paths use, the block-size rows that tell several warps on one SM
from several SMs, and the SM clock that ``nvidia-smi`` reads while kernel A
runs at a small, a middle and a large batch (a card lowers its clock as
more of it is busy, which the same kernel then shows as time).

Where the wrappers take ``lanes`` (the kernels' two forms, one lane a
frame or several), the batch rows also time each form by itself: the
wrapper's own choice by batch should follow the faster one.

The wrappers' interface is the same in every version of the port, so the
same script times another checkout of it: ``--root DIR`` imports
``viterbi_tpu_torch`` from DIR. Run it as a file for that,

    python viterbi_tpu_torch/probes/kbatch.py --root build/parent

and compare two versions only within one run of the card (this one, then
the other, then again). Without ``--root``:
``python -m viterbi_tpu_torch.probes.kbatch``.

Usage: kbatch.py [--root DIR] [--framebits N] [--iters N] [--json PATH]
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

BATCHES = (1, 64, 1024, 4096, 10240, 16384, 24576, 32768, 65536)
CLOCK_BATCHES = (32, 1024, 16384)   # SM clock read under each of these loads
CHAIN_BATCH = 10240     # frames of 2048 superframes: unpacked symbols
MAIN_BATCH = 16384      # the main path's batch
BLOCK_BATCH = 128       # four warps of one-frame threads, or 16 of lanes


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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

    def both(syms, packed, **kw):
        a = _median_ms(torch, lambda: acs_cuda.forward_regs(
            syms, nsteps, ckpt=ck, packed=packed, **kw), iters)
        c = _median_ms(torch, lambda: acs_cuda.forward(
            syms, nsteps, packed=packed, **kw), iters)
        return {"A": a, "C": c}

    forms = (1, acs_cuda.LANES) if "lanes" in inspect.signature(
        acs_cuda.forward_regs).parameters else ()
    out = {"batch": {}, "layouts": {}, "blocks": {}}
    for batch in batches:
        w = words(batch)
        row = both(w, "bt")
        for lanes in forms:
            form = both(w, "bt", lanes=lanes)
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", help="import viterbi_tpu_torch from this "
                                   "checkout instead of the one on the path")
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
    table = sweep(acs_cuda, args.framebits, args.iters)
    where = args.root or "this checkout"
    print(f"kbatch on {_card_line()}: {where} "
          f"({acs_cuda.__file__}), framebits {args.framebits}, ckpt "
          f"{acs_cuda.DECODE_CKPT}, medians of 5 x {args.iters} launches")
    print("  SM clock while kernel A runs, MHz: " + ", ".join(
        f"B={b}: {mhz:.0f}" for b, mhz in table["clock_mhz"].items()))
    for section in ("batch", "layouts", "blocks"):
        for key, row in table[section].items():
            label = f"B={key} packed bt" if section == "batch" else key
            forms = "".join(f"   {k} {v:.3f}" for k, v in row.items()
                            if k not in ("A", "C"))
            print(f"  {label:38s} A {row['A']:8.3f} ms   C {row['C']:8.3f} ms"
                  f"{forms}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": _card_line(), "root": where, **table}, f,
                      indent=1)
    return table


if __name__ == "__main__":
    main()
