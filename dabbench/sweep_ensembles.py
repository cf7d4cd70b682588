"""Sweeps the number of ensembles that a live cell serves, to show where
its fixed load sits against the card's capacity.

    python3 dabbench/sweep_ensembles.py --cell dabplus_ensemble.live \\
        --ensembles 1,2,4,8,16,32 [--seconds 5] [--seed 5]

Each point is one run of the cell (``run.py``, as the benchmark's
command runs it) with its traffic changed for that run by ``--override``:
the live mix's period is 120 ms over the ensembles (one ensemble's
superframes every period), the CIF mix's is 24 ms over them, with that
many ensembles taking turns. Prints p50 and p95 and whether the run was
correct; where p50 passes the period, the backlog grows through the run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def period_ms(traffic: dict, ensembles: int) -> float:
    if traffic["event"] == "cif":
        return 24.0 / ensembles
    return 120.0 / ensembles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--ensembles", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.cell]
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    for e in (int(x) for x in args.ensembles.split(",")):
        over = [f"period_ms={period_ms(traffic, e)}"]
        if traffic["event"] == "cif":
            over.append(f"ensembles={e}")
        cmd = [sys.executable, str(HERE / "run.py"), "--workload",
               args.cell, "--seed", str(args.seed), "--seconds",
               str(args.seconds), "--trace", "0", "--device", args.device]
        for o in over:
            cmd += ["--override", o]
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        if not lines:
            print(f"E={e}: rc {p.returncode} {p.stderr[-800:]}")
            continue
        res = json.loads(lines[-1])
        m = {k: v["value"] for k, v in res["metrics"].items()}
        print(json.dumps({"cell": args.cell, "ensembles": e,
                          "period_ms": period_ms(traffic, e),
                          "p50_ms": m.get("latency_p50_ms"),
                          "p95_ms": m.get("latency_p95_ms"),
                          "events": res["attempted"],
                          "correct": res["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
