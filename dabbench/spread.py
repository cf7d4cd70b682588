"""Runs cells several times, one process a run, and reports the spread
of each metric: the tool that sets and checks the bounds.

    python3 dabbench/spread.py --workload <name> [--workload ...]
        --seeds 11,12,13 [--seconds 10] [--trace 0|1] [--sets 2]
        [--control] [--out chiprun_out/spread.jsonl]

Each run is ``run.py`` with the same arguments the benchmark's command
takes; its last line (or its exit code and the end of its errors) is
appended to ``--out``. With ``--sets 2`` the seeds run twice, the second
set after the first. A spread is the distance between the first and
third quartile (``statistics.quantiles(values, n=4)``) as a share of the
median. For each cell and metric it prints each set's median and spread,
and the two readings a bound is held to: the tightness (the mean of the
sets' spreads, each with its run farthest from its median left out; a
bound under twice it is too tight) and the looseness (the spread of all
runs; a bound over eight times it is too loose).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def without_farthest(values: list) -> list:
    """The runs of a set with the one farthest from its median left
    out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def readings(sets: list) -> dict:
    """Tightness and looseness of a metric over its sets of runs."""
    inner = [spread(without_farthest(v)) for v in sets if len(v) > 2]
    inner = [x for x in inner if x is not None]
    return {"tightness": sum(inner) / len(inner) if inner else None,
            "looseness": spread([x for v in sets for x in v])}


def run_once(workload, seed, seconds, trace, extra, timeout) -> dict:
    cmd = [sys.executable, str(HERE / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace), *extra]
    t0 = time.time()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = 124, exc.stdout or "", exc.stderr or ""
        out = out if isinstance(out, str) else out.decode()
        err = err if isinstance(err, str) else err.decode()
    rec = {"workload": workload, "seed": seed, "seconds": seconds,
           "trace": trace, "extra": extra, "rc": rc,
           "wall_s": time.time() - t0}
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if lines:
        rec["result"] = json.loads(lines[-1])
    rec["stderr_tail"] = err[-1500:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out", default="chiprun_out/spread.jsonl")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    extra = ["--control"] if args.control else []
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    table: dict = {}
    for w in args.workload:
        for s in range(args.sets):
            for seed in seeds:
                rec = run_once(w, seed, args.seconds, args.trace, extra,
                               args.timeout)
                rec["set"] = s
                with open(out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                res = rec.get("result") or {}
                brief = {k: round(v["value"], 4) for k, v in
                         res.get("metrics", {}).items()}
                checks = {k: v["value"] for k, v in
                          res.get("checks", {}).items()}
                print(f"{w} set {s} seed {seed} rc {rec['rc']} "
                      f"wall {rec['wall_s']:.1f}s correct "
                      f"{res.get('correct')} {brief} checks {checks}"
                      + ("" if res else " " + rec["stderr_tail"][-600:]),
                      flush=True)
                for k, v in res.get("metrics", {}).items():
                    table.setdefault((w, s, k), []).append(v["value"])
    for (w, s, k), vals in sorted(table.items()):
        sp = spread(vals)
        print(f"SPREAD {w} set {s} {k}: median {statistics.median(vals):.6g}"
              f" spread {sp if sp is None else round(sp, 5)} n {len(vals)}")
    by_metric: dict = {}
    for (w, s, k), vals in sorted(table.items()):
        by_metric.setdefault((w, k), []).append(vals)
    for (w, k), sets in by_metric.items():
        r = readings(sets)
        print(f"READINGS {w} {k}: tightness {r['tightness']} looseness "
              f"{r['looseness']} sets {len(sets)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
