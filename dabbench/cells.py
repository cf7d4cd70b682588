"""Finds what a cell is made of by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix, one kind
of event or call, one loop or one metric is a file of its own under the
benchmark's directory, found by its name:

* ``configs/<config>.json``: the deployment (source, ``assumed``, the
  signals it receives) and ``entries``: for each role of a call, the
  entry adapter that makes it;
* ``traffic/<traffic>.json``: the ``loop``, the ``event``, the ``signal``
  and the parameters the generator reads; its ``entries`` (if any) go
  over the configuration's;
* ``entries/<name>.py``: an entry adapter, ``program(sut, pool, call,
  state)`` (the program's call, host arrays in and out), ``control(ref,
  pool, call, state)`` (the reference in the program's place),
  ``expect(ref, pool, call)`` (the answer the call must give) and
  ``compare(got, want) -> {number: value}``;
* ``gen/events/<event>.py``: a generator, ``build(signal, traffic, gen,
  device) -> (pools, events)`` (``gen/traffic.py``);
* ``loops/<loop>.py``: ``drive(workload, caller, seconds, tracer)`` and
  ``PER_EVENT``;
* ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.

A later cell, mix, entry, event kind, loop or metric is new files and new
entries, never an edit. A JSON file may hold a ``"cpu"`` object: the
sizes that the CPU rehearsal (``--device cpu``) uses instead, merged over
the rest.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

#: the benchmark's own directory and the checkout that holds it
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over`` merged in, object by object."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def _load_json(path: Path, cpu: bool) -> dict:
    data = json.loads(path.read_text())
    over = data.pop("cpu", None)
    return merge(data, over) if cpu and over else data


def plugin(path: Path):
    """The module in the file ``path``, loaded by its path."""
    if not path.exists():
        raise FileNotFoundError(f"no {path.parent.name} file {path}")
    tag = "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(
        "dabbench_" + tag.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: object          # module with read(run)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    events: object          # gen/events/<event>.py
    loop: object            # loops/<loop>.py
    entries: dict           # role -> (name, entries/<name>.py)
    end_to_end: list[Metric]
    per_layer: list[Metric]


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load(workload: str, root: Path = ROOT, cpu: bool = False,
         overrides: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``, its files
    read and its modules loaded; ``overrides`` go over its traffic file
    (a sweep's changed parameters)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / Path(conf["file"]).parts[0]
    config = _load_json(root / conf["file"], cpu)
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json", cpu)
    traffic = merge(traffic, overrides or {})
    roles = merge(config.get("entries", {}), traffic.get("entries", {}))
    entries = {role: (name, plugin(bench_dir / "entries" / f"{name}.py"))
               for role, name in roles.items()}

    def metric(m):
        return Metric(m["name"], m["unit"],
                      plugin(bench_dir / "metrics" / f"{m['name']}.py"))

    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic,
                plugin(bench_dir / "gen" / "events"
                       / f"{traffic['event']}.py"),
                plugin(bench_dir / "loops" / f"{traffic['loop']}.py"),
                entries,
                [metric(m) for m in e2e],
                [metric(m) for m in per_layer])
