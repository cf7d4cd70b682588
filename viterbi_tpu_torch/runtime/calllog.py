"""Call logging, spans and symbol capture: the observability twin of the
reference's VIT_WRITE_LOGFILE / VIT_WRITE_SYMBOLS subsystem
(viterbi.h:50-80, deconvolve.cpp:555-650, dllmain.cpp:64-107), and the
port's one tracing system.

**Spans.** ``span(name, **counters)`` marks one stage of a call: the
exports (``api.deconvolve``, ``api.deconvolve_batch``,
``api.rs_check_superframe``) and the DAB+ chain (``chain``) are a call's
root, and their stages (``ingest``, ``depuncture``, ``viterbi``,
``rs``, ``readback``) its children. Tracing is on while a torch profiler
runs or call logging is on (config key ``log_calls=1``); the switch is
read once, by a call's root, and its stages follow it (a thread-local
stack). Off, ``span`` returns one shared no-op object, which is false,
and records nothing.
On, a span

* enters ``torch._C._profiler._RecordFunctionFast("viterbi_tpu_torch.
  <name>")`` where a profiler runs (a host operation of ``cat``
  ``cpu_op``), so it lies on the profiler's timeline beside the device's
  kernels and copies; with call logging alone it enters none;
* is appended, at its end, to a bounded buffer read by ``spans()``: its
  ``name``, the ``request`` id every span of one call shares (``seq``),
  its ``parent``'s name, its ``thread``, ``time.perf_counter_ns()`` at
  its start and end (``t0_ns``, ``t1_ns``), and the ``counters`` set on
  it by ``count()`` (``h2d_bytes``, ``staged_chunks``, ``d2h_bytes``,
  the depuncture stage's ``kept_bytes`` and ``mother_bytes``, the
  kernels' ``launches``, and on ``viterbi`` kernel A's form,
  ``acs_lanes``: its lanes a frame, where it launched).

**Call logging.** An export's root span is the logged call:
``Span.record(kind, symbols, **shape)`` gives it its kind and shape, and
at the span's end one line is written: sequence number (the request id),
wall-clock timestamp, inter-call dT, thread id, duration, re-entrancy
depth, the call shape, and the call's stage times and ``h2d_bytes``. The
log file stays open, line-buffered, while logging is on, so each line
reaches the file whole when it is written. With symbol capture on, each
call's raw symbols are saved as one ``.npy`` in a directory beside the
log. A cumulative summary (per-kind counts, durations, buffer footprint
and identity, thread first/last sight, totals by stage) is appended when
logging is disabled or at interpreter exit (dllmain.cpp:325-357).
"""

from __future__ import annotations

import atexit
import collections
import itertools
import os
import threading
import time

import numpy as np
import torch

from . import config as config_mod

_lock = threading.Lock()
_state = {
    "enabled": False, "symbols": False, "path": None, "file": None,
    "seq": itertools.count(), "last_entry": 0.0, "entry_depth": 0,
    "sym_dir": None, "stats": {}, "stages": {}, "t_enabled": None,
    "threads": {},
}

# cap on distinct buffer addresses remembered per call kind
_ADDR_CAP = 65536
#: the span records kept, newest last
SPAN_CAP = 1 << 16
PREFIX = "viterbi_tpu_torch."
#: the counters summed by stage in the log and its summary
_STAGE_COUNTERS = ("h2d_bytes", "staged_chunks", "d2h_bytes", "kept_bytes",
                   "mother_bytes", "launches")


_spans: collections.deque = collections.deque(maxlen=SPAN_CAP)

#: ``_prof._is_profiler_enabled``: whether a torch profiler runs
_prof = torch.autograd.profiler
#: ``_profiler._RecordFunctionFast``: the span on the profiler's timeline
_profiler = torch._C._profiler


class _Thread(threading.local):
    #: the spans open on this thread, the call's root first; None outside
    #: a traced call
    stack = None


_tls = _Thread()


class _Off:
    """What ``span`` returns while tracing is off: false, records
    nothing."""
    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def record(self, kind, symbols, source=None, **shape):
        pass


_OFF = _Off()


class Span:
    """One span: while open, what ``span`` returns; once closed, the
    record ``spans()`` reads."""
    __slots__ = ("name", "request", "parent", "thread", "t0_ns", "t1_ns",
                 "counters", "children", "_emit", "_fn", "_call")

    def __init__(self, name: str, counters: dict):
        self.name = name
        self.counters = counters
        self._call = None

    def count(self, **counters) -> None:
        """Record counters on this span (read only while tracing is
        on: guard their computation with ``if span:``)."""
        self.counters.update(counters)

    def record(self, kind: str, symbols, source=None, **shape) -> None:
        """Make this span a logged call of ``kind`` while call logging is
        on: ``symbols`` the call's input (its bytes, and its capture with
        symbol capture on), ``source`` the caller's original buffer when
        ``symbols`` is a derived view or temporary, so buffer-identity
        churn tracks the caller's allocation (non-ndarray sources are not
        tracked); ``shape`` goes into the log line."""
        if _state["enabled"]:
            self._call = _Call(self, kind, shape, symbols, source)

    def __enter__(self):
        stack = _tls.stack
        if stack is None:
            # next() on the shared counter is atomic under the GIL
            self.request = next(_state["seq"])
            self.parent = None
            self.thread = threading.get_ident()
            self._emit = _prof._is_profiler_enabled
            stack = _tls.stack = []
        else:
            up = stack[-1]
            self.request, self.thread = up.request, up.thread
            self.parent = up.name
            self._emit = up._emit
        self.children = []
        if self._emit:
            self._fn = _profiler._RecordFunctionFast(PREFIX + self.name)
            self._fn.__enter__()
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.perf_counter_ns()
        stack = _tls.stack
        stack.pop()
        if stack:
            stack[-1].children.append(self)
        else:
            _tls.stack = None
        if self._emit:
            self._fn.__exit__(*exc)
            self._fn = None
        if self._call is not None:
            self._call.log(self)
            self._call = None
        self.children = None
        _spans.append(self)
        return False


def span(name: str, **counters):
    """A context manager around one stage of a call, recorded while
    tracing is on (see the module's docstring); off, the shared no-op
    object, which is false."""
    if _tls.stack is None and not (_state["enabled"]
                                   or _prof._is_profiler_enabled):
        return _OFF
    return Span(name, counters)


def spans(clear: bool = False) -> list:
    """The span records kept (at most ``SPAN_CAP``, oldest first);
    ``clear`` empties the buffer."""
    out = list(_spans)
    if clear:
        _spans.clear()
    return out


def configure(enabled: bool, symbols: bool = False,
              path: str | None = None) -> None:
    with _lock:
        was_enabled = _state["enabled"]
        if was_enabled and not enabled:
            _append_locked(_summary_text_locked())
            _close_locked()
        _state["enabled"] = enabled
        _state["symbols"] = symbols
        if enabled and not was_enabled:
            _state["stats"] = {}
            _state["stages"] = {}
            _state["seq"] = itertools.count()
            _state["threads"] = {}
            _state["t_enabled"] = time.time()
        if enabled:
            base = path or os.path.join(
                os.path.dirname(config_mod.default_path()),
                time.strftime("%Y%m%d_%H%M%S"))
            os.makedirs(os.path.dirname(base + ".log") or ".",
                        exist_ok=True)
            if base + ".log" != _state["path"] or _state["file"] is None:
                _close_locked()
                _state["path"] = base + ".log"
                try:
                    _state["file"] = open(_state["path"], "a", buffering=1)
                except OSError:
                    _state["file"] = None
            if symbols:
                _state["sym_dir"] = base + "_sym"
                os.makedirs(_state["sym_dir"], exist_ok=True)


def enabled() -> bool:
    return _state["enabled"]


def _append_locked(text: str) -> None:
    f = _state["file"]
    if f is None:
        return
    try:
        f.write(text)
    except OSError:
        pass


def _close_locked() -> None:
    f, _state["file"] = _state["file"], None
    if f is not None:
        try:
            f.close()
        except OSError:
            pass


def _summary_text_locked() -> str:
    span_s = (time.time() - _state["t_enabled"]) if _state["t_enabled"] \
        else 0
    calls = sum(s["count"] for s in _state["stats"].values())
    lines = [f"--- summary: {calls} calls in {span_s:.1f} s ---\n"]
    for kind, s in sorted(_state["stats"].items()):
        lines.append(
            f"  {kind}: {s['count']} calls, total {s['total_us']/1e3:.1f} ms,"
            f" max {s['max_us']:.0f} us, buffers {s['min_bytes'] or 0}"
            f"..{s['max_bytes']} B\n")
        seen = s.get("_addr_seen")
        if seen:
            # buffer identity churn (deconvolve.cpp:625-628): 1 = the
            # caller reuses one buffer, count == calls = alloc per call
            lines.append(
                f"    buffer identity: {len(seen)} distinct arrays, "
                f"addr 0x{min(seen):x}..0x{max(seen):x}\n")
    for name, s in sorted(_state["stages"].items()):
        sums = "".join(f", {k} {s[k]}" for k in _STAGE_COUNTERS if k in s)
        lines.append(f"  stage {name}: {s['count']} spans, total "
                     f"{s['total_us']/1e3:.1f} ms{sums}\n")
    # thread first/last sight (dllmain.cpp:260-307)
    t0 = _state["t_enabled"] or 0
    for tid, t in sorted(_state["threads"].items()):
        lines.append(
            f"  thread {tid & 0xFFFF:5d}: {t['calls']} calls, "
            f"first seen +{t['first_seen'] - t0:.3f} s, "
            f"last seen +{t['last_seen'] - t0:.3f} s\n")
    return "".join(lines)


def summary() -> dict:
    """Cumulative stats since logging was enabled (also appended to the
    log on disable/exit): ``calls``, the logged calls; ``stats`` by
    kind; ``stages``, totals of the logged calls' stage spans;
    ``threads``."""
    with _lock:
        stats = {}
        for k, v in _state["stats"].items():
            rec = {kk: vv for kk, vv in v.items()
                   if not kk.startswith("_")}
            seen = v.get("_addr_seen")
            if seen:
                rec["distinct_buffers"] = len(seen)
                rec["addr_min"] = min(seen)
                rec["addr_max"] = max(seen)
            stats[k] = rec
        return {
            "calls": sum(s["count"] for s in _state["stats"].values()),
            "stats": stats,
            "stages": {k: dict(v) for k, v in _state["stages"].items()},
            "threads": {tid: dict(t)
                        for tid, t in _state["threads"].items()},
        }


@atexit.register
def _exit_summary() -> None:  # pragma: no cover - exercised at exit
    with _lock:
        if _state["enabled"]:
            _append_locked(_summary_text_locked())
        _close_locked()


class _Call:
    """The log's bookkeeping of one logged call, from ``Span.record`` to
    the span's end."""
    __slots__ = ("kind", "shape", "nbytes", "addr", "depth", "dt_ms")

    def __init__(self, sp: Span, kind: str, shape: dict, symbols, source):
        self.kind = kind
        self.shape = shape
        if isinstance(symbols, torch.Tensor):     # resident on its device
            self.nbytes = symbols.numel() * symbols.element_size()
        else:
            symbols = np.asarray(symbols)
            self.nbytes = symbols.nbytes
        if source is None:
            source = symbols
        base = source if isinstance(source, np.ndarray) else None
        self.addr = base.ctypes.data if base is not None and base.size \
            else 0
        tid = sp.thread
        with _lock:
            _state["entry_depth"] += 1
            self.depth = _state["entry_depth"]
            now = time.time()
            self.dt_ms = ((now - _state["last_entry"]) * 1e3
                          if _state["last_entry"] else 0.0)
            _state["last_entry"] = now
            thr = _state["threads"].get(tid)
            if thr is None:
                thr = {"first_seen": now, "calls": 0}
                _state["threads"][tid] = thr
                _append_locked(f"        {time.strftime('%H:%M:%S')}  "
                               f"thread {tid & 0xFFFF:5d} first seen\n")
            thr["calls"] += 1
            thr["last_seen"] = now
        if _state["symbols"]:
            arr = symbols.cpu().numpy() \
                if isinstance(symbols, torch.Tensor) else symbols
            np.save(os.path.join(_state["sym_dir"],
                                 f"{sp.request:08d}_{kind}.npy"), arr)

    def log(self, sp: Span) -> None:
        """At the end of the call's span: its line and its stats."""
        dur_us = (sp.t1_ns - sp.t0_ns) / 1e3
        with _lock:
            _state["entry_depth"] -= 1
            s = _state["stats"].setdefault(self.kind, {
                "count": 0, "total_us": 0.0, "max_us": 0.0,
                "min_bytes": None, "max_bytes": 0})
            s["count"] += 1
            s["total_us"] += dur_us
            s["max_us"] = max(s["max_us"], dur_us)
            if self.nbytes:
                s["min_bytes"] = (self.nbytes if s["min_bytes"] is None
                                  else min(s["min_bytes"], self.nbytes))
                s["max_bytes"] = max(s["max_bytes"], self.nbytes)
            if self.addr:
                seen = s.setdefault("_addr_seen", set())
                if len(seen) < _ADDR_CAP:
                    seen.add(self.addr)
            shape = " ".join(f"{k}={v}" for k, v in self.shape.items())
            _append_locked(
                f"{sp.request:6d}  {time.strftime('%H:%M:%S')}"
                f"  dT: {self.dt_ms:8.3f} ms  TID: {sp.thread & 0xFFFF:5d}"
                f"  {self.kind}: {dur_us:9.1f} us  ReE: {self.depth - 1}"
                f"  {shape}{_stages_locked(sp.children)}\n")


def _stages_locked(children) -> str:
    """The stage spans of one logged call: their times for its log line,
    added to the summary's totals by stage."""
    parts, h2d = [], 0
    for r in children:
        us = (r.t1_ns - r.t0_ns) / 1e3
        parts.append(f"{r.name} {us:.1f}")
        s = _state["stages"].setdefault(r.name,
                                        {"count": 0, "total_us": 0.0})
        s["count"] += 1
        s["total_us"] += us
        for k in _STAGE_COUNTERS:
            if k in r.counters:
                s[k] = s.get(k, 0) + r.counters[k]
        h2d += r.counters.get("h2d_bytes", 0)
    if not parts:
        return ""
    return f"  [{' '.join(parts)} us  h2d_bytes={h2d}]"
