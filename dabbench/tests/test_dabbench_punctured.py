"""The two cells of the ``dabplus_punctured`` configuration and the fringe
channel: the punctured mix's geometry (its CUs fill a mode I CIF, each
subchannel's kept symbols are 64 a CU), the pools the program and the
reference read, the CPU rehearsal of both cells (correct, their metrics
by name, a broken program not correct), and on the card each cell
correct with every metric it lists and the control not correct.

    python -m pytest dabbench/tests/test_dabbench_punctured.py -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dabbench import cells, roofline_depuncture
from dabbench.gen import channel
from dabbench.reference.depuncture import depuncture

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "dabbench"
PUNCTURED, FRINGE = "dabplus_punctured.bulk", "dabplus_ensemble.fringe"
#: EEP-A sub-channel size in CUs a multiple of 8 kbit/s, by level
CU_PER_8KBPS = {1: 12, 2: 8, 3: 6, 4: 4}


def _run(*args, timeout=600):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), *args],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _args(cell, seed, trace=0, device="cpu"):
    out = ["--workload", cell, "--seed", str(seed), "--seconds", "1.5",
           "--trace", str(trace)]
    return out + (["--device", "cpu"] if device == "cpu" else [])


def _listed(cell, kind):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}


def test_the_mix_fills_a_cif_and_keeps_64_symbols_a_cu():
    signal = cells.load(PUNCTURED).config["signals"]["ensemble"]
    cus = kbps = 0
    for s in signal["services"]:
        cu = CU_PER_8KBPS[s["level"]] * s["kbps"] // 8
        kept = int(channel.eep_mask(s["kbps"], s["level"], s["profile"])
                   .sum())
        assert kept == 64 * cu, s
        assert roofline_depuncture.frame_bytes(
            s["kbps"], (s["profile"], s["level"])) == \
            kept + 4 * (24 * s["kbps"] + 6)
        cus += cu * s["subchannels"]
        kbps += s["kbps"] * s["subchannels"]
    assert (cus, kbps) == (864, 1056)


def test_the_pools_hold_the_punctured_symbols_and_their_depuncture():
    cell = cells.load(PUNCTURED, cpu=True)
    signal = cell.config["signals"]["ensemble"]
    gen = torch.Generator().manual_seed(2**31 + 7)
    pools, events = cell.events.build(signal, cell.traffic, gen, "cpu")
    for pool in pools.values():
        kbps, (profile, level) = pool.kbps, pool.protection
        mask = channel.eep_mask(kbps, level, profile)
        assert pool.received.dtype == np.int32
        assert pool.received.shape[1:] == (5, int(mask.sum()))
        assert pool.symbols.shape[1:] == (5, mask.size)
        assert np.array_equal(
            depuncture(torch.from_numpy(pool.received), mask).numpy(),
            pool.symbols)
        assert (pool.symbols[..., ~mask] == 127).all()
    calls = events(0)
    assert [c.pool for c in calls] == list(pools)
    assert all(c.superframes * 5 == c.frames for c in calls)


@pytest.mark.parametrize("cell", [PUNCTURED, FRINGE])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cells_rehearse_correct_on_the_cpu(cell, trace):
    res = _run(*_args(cell, 2**31 + 11 + trace, trace))
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    if trace:
        # on the CPU the device readers find nothing; the span does
        want = {"chain.depuncture_span_share.punctured"} \
            if cell == PUNCTURED else set()
    else:
        want = _listed(cell, "end_to_end")
    assert set(res["metrics"]) == want


def test_a_broken_program_is_not_correct_on_the_punctured_cell(tmp_path):
    """An answer altered where the program made it."""
    script = tmp_path / "broken.py"
    script.write_text(f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from dabbench import cells, run

def load(*a, _load=cells.load, **k):
    cell = _load(*a, **k)
    for name, entry in cell.entries.values():
        real = entry.program

        def program(*args, real=real):
            audio, errors = real(*args)
            audio = audio.copy()
            audio.reshape(-1)[0] ^= 1
            return audio, errors
        entry.program = program
    return cell

cells.load = load
sys.exit(run.main(sys.argv[1:]))
""")
    p = subprocess.run([sys.executable, str(script),
                        *_args(PUNCTURED, 2**31 + 17)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is False and res["failed"] > 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [PUNCTURED, FRINGE])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cells_run_correct_on_the_card(cell, trace):
    _card()
    res = _run(*_args(cell, 2147483659 + trace, trace, "cuda"))
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    assert set(res["metrics"]) == _listed(cell, kind)


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card():
    """The reference fed 7-bit symbols in the program's place, on the
    full mix (its EEP-4A subchannels decode near their limit)."""
    _card()
    res = _run(*_args(PUNCTURED, 2147483693, 0, "cuda"), "--control")
    assert res["correct"] is False
