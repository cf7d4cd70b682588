"""The cells on the card, briefly: each runs, prints its metrics and
comes out correct, and the control does not. Needs a CUDA card (marker
``cuda``); without one each test skips, decided inside the test.

    python -m pytest dabbench/tests/test_dabbench_card.py -q -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["dabplus_ensemble.bulk", "dabplus_ensemble.live",
         "dll_export.cif", "dll_export.bulk"]


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(*args):
    p = subprocess.run([sys.executable, str(ROOT / "dabbench" / "run.py"),
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(cell, trace):
    _card()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    res = _run("--workload", cell, "--seed", "2147483659", "--seconds",
               "3", "--trace", str(trace))
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    _card()
    res = _run("--workload", cell, "--seed", "2147483693", "--seconds",
               "3", "--trace", "0", "--control")
    assert not res["correct"]
