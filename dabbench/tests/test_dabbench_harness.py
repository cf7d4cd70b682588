"""The harness on the CPU: the result line's keys, a cell added as new
files only, the open loop's timing from the due time, what it may import,
and that a broken program or the control comes out not correct.

The runs use ``--device cpu`` (the files' ``cpu`` sizes and the program's
plain path), each in a process of its own as the benchmark's command runs.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from dabbench import calls, cells
from dabbench.gen import traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "dabbench"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(args, cwd=ROOT, script=None, timeout=600):
    cmd = [sys.executable, str(script or BENCH / "run.py"), *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                       env=env, timeout=timeout)
    return p


def _last(p):
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _cell_args(workload, seed=7, seconds=1, trace=0):
    return ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", "cpu"]


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_exactly_the_contracts_keys(trace):
    res = _last(_run(_cell_args("dll_export.bulk", seed=2**31 + 5,
                                trace=trace)))
    keys = [k for k in res if k not in ("card", "checks")]
    assert keys == KEYS + (["breakdown"] if "breakdown" in res else [])
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    names = set(res["metrics"])
    if trace:
        assert "busy_s" in res["device"] and "window_s" in res["device"]
    else:
        assert names == {"setup_s", "decoded_mbit_s"}


def test_without_a_card_the_command_fails_and_prints_no_result():
    p = _run(["--workload", "dll_export.bulk", "--seed", "1", "--seconds",
              "1", "--trace", "0"])
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_a_folder_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "dabbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cmd = [sys.executable, str(tmp_path / "dabbench" / "run.py"),
           *_cell_args("dll_export.bulk")]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def _added_cell(tmp_path):
    """A copy of the benchmark with a new cell made of new files only: a
    configuration, a traffic mix, an entry adapter for a new call (the
    superframes already on the device, as from a demodulator on the
    card), a generator of events, a loop and a metric."""
    shutil.copytree(BENCH, tmp_path / "dabbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    new = tmp_path / "dabbench"
    before = {p: p.read_bytes() for p in new.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH / "configs" / "dabplus_ensemble.json")
                      .read_text())
    conf["name"] = "resident_ensemble"
    conf["entries"] = {"superframes": "resident_superframes"}
    (new / "configs" / "resident_ensemble.json").write_text(
        json.dumps(conf))
    (new / "traffic" / "one_group.json").write_text(json.dumps({
        "loop": "each_once", "events": 3, "signal": "ensemble",
        "event": "lowest_bitrate", "superframes_per_event": 2,
        "warmup_events": 1, "trace_events": 2, "why": "test"}))
    (new / "entries" / "resident_superframes.py").write_text(
        textwrap.dedent("""
        import torch
        from dabbench import checks

        ON_DEVICE = {}          # moved once, in the warm-up

        def _resident(side, pool):
            if pool.name not in ON_DEVICE:
                dev = getattr(side, "device", None) or "cuda"
                ON_DEVICE[pool.name] = torch.from_numpy(pool.symbols).to(dev)
            return ON_DEVICE[pool.name]

        def program(sut, pool, call, state):
            dab = sut.module("viterbi_tpu_torch.models.dab")
            audio, errors = dab.decode_audio_superframes(
                _resident(sut, pool)[call.start:call.stop], pool.kbps)
            return audio.cpu().numpy(), errors.cpu().numpy()

        def expect(ref, pool, call):
            errors, audio, _ = ref.checked(pool.name)
            return audio[call.start:call.stop], errors[call.start:call.stop]

        def control(ref, pool, call, state):
            return expect(ref, pool, call)

        def compare(got, want):
            return {"bytes_wrong": checks.bytes_wrong(got[0], want[0]),
                    "codes_wrong": checks.bytes_wrong(got[1], want[1])}
        """))
    (new / "gen" / "events" / "lowest_bitrate.py").write_text(
        textwrap.dedent("""
        from dabbench.gen.traffic import Call, services, superframe_pools

        def build(signal, traffic, gen, device):
            kb = services(signal)[-1][0]
            per = traffic["superframes_per_event"]
            pools = superframe_pools({kb: 2 * per}, signal, gen, device)

            def events(k):
                s = (k % 2) * per
                return [Call("superframes", f"sf{kb}", s, s + per,
                             bits=per * 5 * 24 * kb, frames=per * 5,
                             superframes=per)]
            return pools, events
        """))
    (new / "loops" / "each_once.py").write_text(textwrap.dedent("""
        from dabbench.calls import now, run_event
        PER_EVENT = True

        def drive(workload, caller, seconds, tracer=None):
            events, t0 = [], now()
            for k in range(3):
                if tracer and k == 0:
                    tracer.start()
                if tracer and k == 1:
                    tracer.begin()
                ev = run_event(caller, workload, k, now())
                ev.traced = tracer is not None and k >= 1
                if tracer and k == 2:
                    tracer.stop()
                events.append(ev)
            return events, t0, events[-1].done
        """))
    (new / "metrics" / "calls.traced.py").write_text(textwrap.dedent("""
        def read(run):
            return float(len(run.records(traced=True)))
    """))
    bench["configs"].append({"name": "resident_ensemble", "source": "test",
                             "file": "dabbench/configs/"
                                     "resident_ensemble.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "resident_ensemble.one_group",
                               "config": "resident_ensemble",
                               "traffic": "one_group", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][1]["workloads"].append("resident_ensemble.one_group")
    bench["per_layer"].append({"name": "calls.traced", "unit": "calls",
                               "better": "lower", "source": "program_span",
                               "layer": "models.dab",
                               "moves": "decoded_mbit_s",
                               "workloads": ["resident_ensemble.one_group"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return new, before


def test_a_new_call_config_mix_loop_and_metric_added_as_new_files(
        tmp_path):
    """A new cell is new files and new entries: no file of the harness is
    edited, and each new module is found by its name."""
    new, before = _added_cell(tmp_path)
    script = new / "run.py"
    cell = "resident_ensemble.one_group"
    res = _last(_run(_cell_args(cell), cwd=tmp_path, script=script))
    assert res["correct"] and res["attempted"] == 3
    assert set(res["metrics"]) == {"setup_s", "decoded_mbit_s"}
    res = _last(_run(_cell_args(cell, trace=1), cwd=tmp_path,
                     script=script))
    assert res["correct"]
    assert res["metrics"]["calls.traced"]["value"] == 2.0
    res = _last(_run(_cell_args(cell) + ["--control"], cwd=tmp_path,
                     script=script))
    assert isinstance(res["correct"], bool)   # the control side runs too
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_an_override_changes_the_traffic_of_one_run():
    """A sweep's point: the traffic file's parameter set for one run."""
    res = _last(_run(_cell_args("dll_export.cif", seconds=1)
                     + ["--override", "period_ms=500"]))
    assert res["attempted"] == 2


class _FakeEntry:
    """An entry adapter that answers at once, and stalls once."""

    def __init__(self, stall_at=None, stall_s=0.0):
        self.n, self.stall_at, self.stall_s = 0, stall_at, stall_s

    def program(self, sut, pool, call, state):
        self.n += 1
        if self.n == self.stall_at:
            import time
            time.sleep(self.stall_s)
        return 0, np.zeros((call.stop - call.start, 1), np.uint8)


class _FakeSide:
    SIDE = "program"


def _fake_workload(period_s, entry):
    pool = traffic.Pool("fr8", None, 8, np.zeros((4, 56), np.int32))
    return traffic.Workload(
        loop="open", period_s=period_s, pools={"fr8": pool},
        events=lambda k: [traffic.Call("frames", "fr8", 0, 1, bits=8)],
        trace_events=1, entries={"frames": ("fake", entry)})


def _p95(events):
    lat = np.array([ev.done - ev.due for ev in events])
    return float(np.percentile(lat, 95)), lat


def test_a_stall_raises_the_tail_of_the_events_it_delays():
    """The open loop times each event from its due time: one call that
    stalls for 0.2 s makes the events due during the stall late too, so
    p95 grows far past the stalled call alone."""
    loop = cells.plugin(BENCH / "loops" / "open.py")
    w = _fake_workload(0.01, _FakeEntry())
    calm, _ = _p95(loop.drive(w, calls.Caller(w, _FakeSide()), 1.0)[0])
    w = _fake_workload(0.01, _FakeEntry(10, 0.2))
    events = loop.drive(w, calls.Caller(w, _FakeSide()), 1.0)[0]
    stalled, lat = _p95(events)
    assert calm < 0.01
    assert stalled > 0.05
    assert (lat > 0.05).sum() >= 10     # the events queued behind it


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _top(names) -> set:
    return {n.split(".")[0] for n in names}


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    """By whole top-level names: viterbi_tpu_torch begins with viterbi_tpu
    and is allowed, viterbi_tpu is not."""
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        found = _top(_imports(path)) & {"jax", "jaxlib", "flax",
                                         "viterbi_tpu"}
        assert not found, f"{path} imports {found}"
    code = ("import sys, runpy; sys.argv = ['run.py'] + sys.argv[1:];"
            "import dabbench.run as r; r.main(sys.argv[1:]);"
            "print('MODULES', sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code,
                        *_cell_args("dll_export.bulk")], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    mods = eval(p.stdout.split("MODULES", 1)[1])
    assert "viterbi_tpu_torch" in mods
    assert not set(mods) & {"jax", "jaxlib", "flax", "viterbi_tpu"}


def test_the_reference_and_the_generator_import_nothing_of_the_program():
    for sub in ("reference", "gen"):
        for path in (BENCH / sub).rglob("*.py"):
            assert "viterbi_tpu_torch" not in _top(_imports(path)), path
    code = ("import sys; import dabbench.reference.viterbi, "
            "dabbench.reference.rs, dabbench.gen.traffic; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    mods = eval(p.stdout)
    assert not set(mods) & {"viterbi_tpu_torch", "viterbi_tpu", "jax"}


def test_the_control_comes_out_not_correct():
    """The reference fed 7-bit symbols in the program's place, on a noisy
    signal where it decodes other bytes than the 8-bit reference."""
    p = _run(_cell_args("dll_export.bulk", seed=3) + ["--control"])
    res = _last(p)
    assert res["correct"] is False
    assert res["checks"]["bytes_wrong"]["value"] > 0


_BROKEN = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from dabbench import cells, run

FAULT = {fault!r}
last = {{}}


def _break(role, got):
    if FAULT == "stale":                # returns its state unchanged
        prev = last.get(role)
        last[role] = got
        return prev if prev is not None else got
    if FAULT == "half":                 # half of the batch left out
        return tuple(x[: len(x) // 2] if isinstance(x, np.ndarray)
                     and x.ndim else x for x in got)
    if FAULT == "alter":                # an answer altered where made
        out, done = [], False
        for x in got:
            if not done and isinstance(x, np.ndarray) and \\
                    x.dtype == np.uint8:
                x = x.copy()
                x.reshape(-1)[0] ^= 1
                done = True
            out.append(x)
        return tuple(out)
    return got


def _broken(role, program):
    return lambda *a: _break(role, program(*a))


def load(*a, _load=cells.load, **k):
    cell = _load(*a, **k)
    for role, (name, entry) in cell.entries.items():
        entry.program = _broken(role, entry.program)
    return cell


cells.load = load
sys.exit(run.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("workload,fault", [
    ("dll_export.bulk", "stale"), ("dll_export.bulk", "half"),
    ("dll_export.bulk", "alter"), ("dabplus_ensemble.bulk", "half"),
    ("dabplus_ensemble.live", "alter"), ("dll_export.cif", "stale")])
def test_a_broken_timed_path_comes_out_not_correct(tmp_path, workload,
                                                  fault):
    script = tmp_path / "broken.py"
    script.write_text(_BROKEN.format(root=str(ROOT), fault=fault))
    res = _last(_run(_cell_args(workload, seconds=1.5), script=script))
    assert res["correct"] is False
    assert res["failed"] > 0
