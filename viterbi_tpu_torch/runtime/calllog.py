"""Call logging / tracing / symbol capture — the observability twin of
the reference's VIT_WRITE_LOGFILE / VIT_WRITE_SYMBOLS subsystem
(viterbi.h:50-80, deconvolve.cpp:555-650, dllmain.cpp:64-107).

Per call: sequence number, wall-clock timestamp, inter-call dT, thread
id, decode duration, re-entrancy depth and the call shape. With symbol
capture on, each call's raw symbols are saved as one ``.npy`` in a
directory beside the log. A cumulative summary (per-kind counts,
durations, buffer footprint and identity, thread first/last sight) is
appended when logging is disabled or at interpreter exit
(dllmain.cpp:325-357).

``configure(..., profile_dir=...)`` additionally runs a
``torch.profiler`` trace (CPU, and CUDA when present), written as a
Chrome trace into ``profile_dir`` when logging stops, and wraps each hot
call in a ``record_function`` span named ``viterbi_tpu_torch.<kind>``.
"""

from __future__ import annotations

import atexit
import os
import threading
import time

import numpy as np
import torch

from . import config as config_mod

_lock = threading.Lock()
_state = {
    "enabled": False, "symbols": False, "path": None,
    "seq": 0, "last_entry": 0.0, "entry_depth": 0, "sym_dir": None,
    "stats": {}, "t_enabled": None, "profile_dir": None,
    "profiler": None, "threads": {},
}

# cap on distinct buffer addresses remembered per call kind
_ADDR_CAP = 65536


def configure(enabled: bool, symbols: bool = False,
              path: str | None = None,
              profile_dir: str | None = None) -> None:
    summary_text = None
    with _lock:
        was_enabled = _state["enabled"]
        if was_enabled and not enabled:
            summary_text = _summary_text_locked()
        _state["enabled"] = enabled
        _state["symbols"] = symbols
        if enabled and not was_enabled:
            _state["stats"] = {}
            _state["seq"] = 0
            _state["threads"] = {}
            _state["t_enabled"] = time.time()
        if enabled:
            base = path or os.path.join(
                os.path.dirname(config_mod.default_path()),
                time.strftime("%Y%m%d_%H%M%S"))
            os.makedirs(os.path.dirname(base + ".log") or ".",
                        exist_ok=True)
            _state["path"] = base + ".log"
            if symbols:
                _state["sym_dir"] = base + "_sym"
                os.makedirs(_state["sym_dir"], exist_ok=True)
    if summary_text is not None:
        _append(summary_text)
        _stop_profiler()
    if enabled and profile_dir:
        _start_profiler(profile_dir)


def enabled() -> bool:
    return _state["enabled"]


def _start_profiler(profile_dir: str) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _state["profile_dir"] = profile_dir
    _state["profiler"] = prof


def _stop_profiler() -> None:
    prof = _state["profiler"]
    if prof is None:
        return
    _state["profiler"] = None
    prof.stop()
    os.makedirs(_state["profile_dir"], exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(_state["profile_dir"], "trace.json"))


def _append(text: str) -> None:
    if _state["path"] is None:
        return
    try:
        with open(_state["path"], "a") as f:
            f.write(text)
    except OSError:
        pass


def _summary_text_locked() -> str:
    span = (time.time() - _state["t_enabled"]) if _state["t_enabled"] else 0
    lines = [f"--- summary: {_state['seq']} calls in {span:.1f} s ---\n"]
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
    log on disable/exit)."""
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
            "calls": _state["seq"],
            "stats": stats,
            "threads": {tid: dict(t)
                        for tid, t in _state["threads"].items()},
        }


@atexit.register
def _exit_summary() -> None:  # pragma: no cover - exercised at exit
    if _state["enabled"]:
        with _lock:
            text = _summary_text_locked()
        _append(text)
        _stop_profiler()


class record:
    """Context manager logging one hot-path call."""

    def __init__(self, kind: str, **shape):
        self.kind = kind
        self.shape = shape
        self.nbytes = 0
        self.addr = 0
        self._span = None

    def __enter__(self):
        if not _state["enabled"]:
            return self
        new_thread = False
        tid = threading.get_ident()
        with _lock:
            self.seq = _state["seq"]
            _state["seq"] += 1
            _state["entry_depth"] += 1
            self.depth = _state["entry_depth"]
            now = time.time()
            self.dt_ms = ((now - _state["last_entry"]) * 1e3
                          if _state["last_entry"] else 0.0)
            _state["last_entry"] = now
            thr = _state["threads"].get(tid)
            if thr is None:
                new_thread = True
                thr = {"first_seen": now, "calls": 0}
                _state["threads"][tid] = thr
            thr["calls"] += 1
            thr["last_seen"] = now
        if new_thread:
            _append(f"        {time.strftime('%H:%M:%S')}  thread "
                    f"{tid & 0xFFFF:5d} first seen\n")
        if _state["profiler"] is not None:
            self._span = torch.profiler.record_function(
                f"viterbi_tpu_torch.{self.kind}")
            self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def capture_symbols(self, symbols, source=None) -> None:
        """``source``: the caller's original buffer when ``symbols`` is a
        derived view or temporary, so buffer-identity churn tracks the
        caller's allocation. Non-ndarray sources are not tracked."""
        arr = np.asarray(symbols)
        self.nbytes = arr.nbytes
        if source is None:
            source = symbols
        base = source if isinstance(source, np.ndarray) else None
        self.addr = base.ctypes.data if base is not None and base.size \
            else 0
        if _state["enabled"] and _state["symbols"]:
            np.save(os.path.join(_state["sym_dir"],
                                 f"{self.seq:08d}_{self.kind}.npy"), arr)

    def __exit__(self, *exc):
        if not _state["enabled"]:
            return False
        if self._span is not None:
            self._span.__exit__(*exc)
        dur_us = (time.perf_counter() - self.t0) * 1e6
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
            line = (f"{self.seq:6d}  {time.strftime('%H:%M:%S')}"
                    f"  dT: {self.dt_ms:8.3f} ms  TID: {threading.get_ident() & 0xFFFF:5d}"
                    f"  {self.kind}: {dur_us:9.1f} us  ReE: {self.depth - 1}"
                    f"  {shape}\n")
        _append(line)
        return False
