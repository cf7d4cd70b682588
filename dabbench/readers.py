"""What several metric readers share: latencies, the traced calls' work,
and the device operations of the trace by kind. A reader returns None
where it finds nothing to read, never 0 for a share."""

from __future__ import annotations

import numpy as np
import torch

from . import roofline

HTOD = r"HtoD|Host to Device"
ACS_REGS = r"acs_regs_kernel"
RS_SUPERFRAMES = r"rs_superframes_kernel"
TAIL_BITS = 6


def latencies_ms(run) -> np.ndarray:
    """Every event of the window, from its due time to its last output on
    the host; one that never ran counts until the loop ended."""
    end = max((ev.done for ev in run.events if ev.done is not None),
              default=run.t_end)
    return np.array([1e3 * ((ev.done if ev.done is not None else end)
                            - ev.due) for ev in run.events])


def call_ms(run, entry) -> np.ndarray:
    """Wall ms of each call of an entry adapter outside the traced
    stretch."""
    return np.array([1e3 * (r.t1 - r.t0) for r in run.records(entry, False)
                     if r.error is None])


def device_seconds(run, pattern) -> float | None:
    if run.trace is None:
        return None
    t = sum(o.t1 - o.t0 for o in run.trace.ops(pattern=pattern))
    return t or None


def share_pct(bound_s: float, time_s: float | None) -> float | None:
    if not time_s or not bound_s:
        return None
    return 100.0 * bound_s / time_s


def traced_calls(run):
    return [r.call for r in run.records(traced=True) if r.error is None]


def acs_regs_bound_s(run) -> float:
    """Kernel A's least time for the traced calls' frames."""
    total = 0.0
    for c in traced_calls(run):
        if c.frames:
            total += roofline.acs_regs_bound(
                c.frames, run.workload.pools[c.pool].framebits,
                run.card["clock_max_sm_hz"])
    return total


def rs_superframes_bound_s(run) -> float:
    """Kernel I's least time on the superframes the traced calls handed
    it (the reference's decoded superframes, equal to the
    program's where the run is correct)."""
    total = 0.0
    dev = "cpu" if run.cpu else "cuda"
    for c in traced_calls(run):
        if not c.superframes:
            continue
        pool = run.workload.pools[c.pool]
        sf = torch.from_numpy(run.table.superframes(c.pool)
                              [c.start:c.start + c.superframes])
        total += roofline.rs_superframes_bound(sf.to(dev), pool.rs_dims,
                                               run.card["clock_max_sm_hz"])
    return total


def idle_share_pct(run) -> float | None:
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
