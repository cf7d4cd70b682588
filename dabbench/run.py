"""Runs one cell of the benchmark once and prints its result line.

    python3 dabbench/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1> [--device cpu] [--control]
                            [--override KEY=JSON ...]

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``viterbi_tpu_torch``). The run:

1. reads the cell (``cells.load``: its files and modules, found by
   name) and needs as many CUDA cards as the cell
   asks for; without them it exits with code 2 and prints no result,
   unless ``--device cpu`` asks for the CPU rehearsal (the files' ``cpu``
   sizes, the program's plain path; the result says ``"platform": "cpu"``);
2. sets up: the program's config file (``auto_best``, the kernels' build
   directory ``build/kernels`` in the checkout), the inputs made on the
   card from ``--seed`` (``gen/traffic.py`` and the cell's
   ``gen/events/<event>.py``) and handed over as host arrays, and a
   warm-up of the cell's own shapes; ``setup_s`` is from the
   process's start to the first timed call;
3. drives the window (``loops/<loop>.py``): ``--seconds`` of the cell's
   loop, every call made by its entry adapter (``entries/``) and
   recorded; with ``--trace 1`` a stretch of it is profiled;
4. reads the device's memory peak, refuses to go on where JAX or the JAX
   package got loaded (exit 3), frees the card and runs the plain reference
   (``answers.Table``) over every input, then compares every answer of the
   window (``checks``, with each entry adapter's ``expect`` and
   ``compare``);
5. prints each compared number beside its limit as the last lines of
   standard error, and as the last line of standard output one JSON
   object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
   end-to-end metrics, or with ``--trace 1`` its per-layer ones, each from
   its reader in ``metrics/``), ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``.

``--control`` puts the reference, fed 7-bit soft symbols, in the
program's place: a run that must come out not correct. ``--override``
sets a parameter of the cell's traffic file for this run (a sweep's
point, such as ``period_ms=7.5``); the benchmark's own runs give none.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.time()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: the benchmark's caches and scratch files, at fixed paths in the checkout
WORK = ROOT / "build" / "dabbench"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(WORK / _sub)
# run as a script: import this folder as the package it is, never its
# modules by their bare names
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from dabbench import answers, calls, cells, checks, devtrace  # noqa: E402
from dabbench.gen import traffic as traffic_gen  # noqa: E402

#: top-level module names that must not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "viterbi_tpu")
CONTROL_SOFT_BITS = 7


def process_age() -> float:
    """Seconds since this process started (``/proc``, 10 ms steps), or
    since this module was imported where there is no ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _T_IMPORT


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def program_config() -> str:
    """The program's config file: ``auto_best`` and the kernels' build
    directory in this checkout, so no tuner's file can change the rung."""
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / "viterbi.txt"
    path.write_text(f"4:0\ncompile_cache={ROOT / 'build' / 'kernels'}\n")
    return str(path)


class Run:
    """What a metric's reader gets: the cell, the workload, every event of
    the window, set-up time, the reference, the card and the trace."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def records(self, entry=None, traced=None):
        """Recorded calls of the window (of one entry adapter, inside or
        outside the traced stretch)."""
        return [r for ev in self.events if ev.done is not None
                and (traced is None or ev.traced == traced)
                for r in ev.records if entry is None or r.entry == entry]

    def traced_events(self):
        return [ev for ev in self.events if ev.traced]


def warm_up(workload, side, n: int) -> None:
    caller = calls.Caller(workload, side)
    for k in range(n):
        for call in workload.event(k):
            rec = caller(call)
            if rec.error:
                raise RuntimeError(f"warm-up call {call} failed: "
                                   f"{rec.error}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=JSON")
    args = ap.parse_args(argv)
    overrides = {}
    for item in args.override:
        key, _, value = item.partition("=")
        overrides[key] = json.loads(value)
    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(1)     # the rehearsal's tiny ops

    cell = cells.load(args.workload, cpu=cpu, overrides=overrides)
    if not cpu and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        print(f"dabbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {torch.cuda.device_count()}; --device cpu runs the "
              "CPU rehearsal", file=sys.stderr)
        return 2
    os.environ["VITERBI_TPU_TORCH_CONFIG"] = program_config()
    dev = torch.device("cpu") if cpu else torch.device("cuda", 0)
    if not cpu:
        torch.cuda.set_device(dev)
        from dabbench import card
        stamp = card.stamp()
    else:
        stamp = {"name": "cpu", "power_limit_w": None,
                 "clock_max_sm_hz": None}

    workload = traffic_gen.build(cell, args.seed, dev)
    if not cpu:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    if args.control:
        side = answers.Table(workload.pools, dev, CONTROL_SOFT_BITS)
    else:
        side = answers.Program(cpu)
    warm_up(workload, side, int(cell.traffic.get("warmup_events", 1)))
    tracer = None
    if args.trace:
        tracer = devtrace.Stretch(WORK, cuda=not cpu)
        tracer.warm_up()
    if not cpu:
        torch.cuda.synchronize()

    # the set-up's objects (inputs, modules) stay out of the collector's
    # passes in the window; the window's own garbage is collected as usual
    gc.collect()
    gc.freeze()
    setup_s = process_age()
    caller = calls.Caller(workload, side, args.seed)
    events, t_start, t_end = cell.loop.drive(workload, caller, args.seconds,
                                             tracer)
    memory_peak = 0 if cpu else int(torch.cuda.max_memory_allocated(dev))

    bad = forbidden_modules()
    if bad:
        print(f"dabbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    del side, caller
    if not cpu:
        torch.cuda.empty_cache()
    table = answers.Table(workload.pools, dev)
    numbers, attempted, failed = checks.compare(
        events, table, workload, per_event=cell.loop.PER_EVENT)
    correct = failed == 0 and all(numbers[k] <= lim
                                  for k, lim in checks.LIMITS.items())

    summary = tracer.summary() if tracer else None
    run = Run(cell=cell, workload=workload, events=events, t_start=t_start,
              t_end=t_end, setup_s=setup_s, table=table, card=stamp,
              trace=summary, cpu=cpu)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = m.reader.read(run)
        if value is None:
            if not cpu:
                print(f"dabbench: metric {m.name} found nothing to read "
                      f"in {cell.name}", file=sys.stderr)
                return 4
            continue
        metrics[m.name] = {"value": float(value), "unit": m.unit}

    device = {"platform": "cpu" if cpu else "gpu",
              "kind": stamp["name"] if cpu else torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        if not cpu:
            result["breakdown"] = summary.breakdown()
    result["card"] = {"power_limit_w": stamp["power_limit_w"],
                      "clock_max_sm_hz": stamp["clock_max_sm_hz"]}
    result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]}
                        for k, v in numbers.items()}
    for k, v in numbers.items():
        print(f"check {k} {v} limit {checks.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
