"""The traced stretch of a ``--trace 1`` run and what is read from it.

``Stretch`` runs ``torch.profiler`` (host and device activity) over a few
whole events of the window, inside a span ``dabbench.stretch`` whose
length is the traced window. The profile is written as a Chrome trace
into the checkout's ``build/dabbench/`` and removed once read, so a run
leaves nothing on disk.

``Summary`` holds what the readers take from it: the device's operations
(kernels, copies, memsets) with their intervals, the host's spans and
operations, the device's busy union inside the window, and the breakdown
the result line carries: the device operations that took most time and
the longest idle gaps by what the host was doing.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import re
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STRETCH = "dabbench.stretch"
TOP = 10


class Stretch:
    """Profiles from ``start()`` to ``stop()``; the traced window is the
    span from ``begin()`` on. The loops run one event between ``start()``
    and ``begin()``: the profiler's first records after it starts can be
    incomplete (a run 20 s into its window lost a whole copy), as
    ``torch.profiler``'s own schedule discards a warm-up step."""

    def __init__(self, out_dir: Path, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._make = lambda: profile(activities=acts)
        self.out_dir = out_dir
        self.cuda = cuda
        self.done = False
        self.path = None

    def warm_up(self) -> None:
        """One empty session, so that the profiler's own set-up is not in
        the window."""
        with self._make():
            if self.cuda:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self) -> None:
        self.prof = self._make()
        self.prof.__enter__()

    def begin(self) -> None:
        from torch.profiler import record_function
        self.span = record_function(STRETCH)
        self.span.__enter__()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.out_dir / f"trace_{os.getpid()}.json"
        self.prof.export_chrome_trace(str(self.path))
        del self.prof
        self.done = True

    def summary(self) -> "Summary":
        try:
            return Summary.read(self.path)
        finally:
            self.path.unlink(missing_ok=True)


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    t0: float        # seconds
    t1: float
    args: dict


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(op: "Op") -> str:
    """A kernel's qualified name without its return type, template
    arguments and parameters; a copy's or memset's name as the profiler
    gives it."""
    if op.cat != "kernel":
        return op.name
    name = op.name.replace("(anonymous namespace)::", "")
    m = re.search(r"[A-Za-z_][\w:]*(?=\s*[<(])", name)
    return m.group(0) if m else name


@dataclasses.dataclass
class Summary:
    window: tuple            # (t0, t1) seconds
    device: list             # Op, clipped to the window
    host: list               # Op
    busy: list               # union of device intervals in the window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def ops(self, cat=None, pattern=None):
        return [o for o in self.device if (cat is None or o.cat == cat)
                and (pattern is None or re.search(pattern, o.name))]

    @staticmethod
    def read(path: Path) -> "Summary":
        events = json.loads(Path(path).read_text())["traceEvents"]
        window, device, host = None, [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            t0 = float(e["ts"]) / 1e6
            op = Op(e.get("name", ""), cat, t0, t0 + float(e["dur"]) / 1e6,
                    e.get("args") or {})
            if cat in DEVICE_CATS:
                device.append(op)
            elif cat in HOST_CATS:
                host.append(op)
                if op.name == STRETCH and cat == "user_annotation":
                    window = (op.t0, op.t1)
        if window is None:
            raise RuntimeError("the trace has no dabbench.stretch span")
        w0, w1 = window
        device = [dataclasses.replace(o, t0=max(o.t0, w0), t1=min(o.t1, w1))
                  for o in device if o.t1 > w0 and o.t0 < w1]
        busy = union([(o.t0, o.t1) for o in device])
        return Summary(window, device, host, busy)

    def gaps(self):
        """The idle intervals of the device inside the window."""
        out, at = [], self.window[0]
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if at < self.window[1]:
            out.append((at, self.window[1]))
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing at each gap's middle (the
        benchmark's span, then the innermost host operation)."""
        by_op: dict = {}
        for o in self.device:
            key = short_name(o)
            by_op[key] = by_op.get(key, 0.0) + (o.t1 - o.t0)
        by_gap: dict = {}
        gaps = sorted(self.gaps(), key=lambda g: (g[0] + g[1]) / 2)
        host = sorted(self.host, key=lambda o: o.t0)
        active, i = [], 0
        for a, b in gaps:
            mid = (a + b) / 2
            while i < len(host) and host[i].t0 <= mid:
                heapq.heappush(active, (host[i].t1, i))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            covering = [host[j] for _, j in active
                        if host[j].t1 >= mid and host[j].name != STRETCH]
            spans = [o for o in covering if o.name.startswith("dabbench.")]
            inner = min(covering, key=lambda o: o.t1 - o.t0, default=None)
            outer = max(spans, key=lambda o: o.t1 - o.t0, default=None)
            label = " > ".join(dict.fromkeys(
                o.name for o in (outer, inner) if o is not None)) \
                or "between events"
            by_gap[label] = by_gap.get(label, 0.0) + (b - a)

        def top(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}
