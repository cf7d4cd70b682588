"""The open loop: event k is due at k * period from the window's start,
whatever the program does, and is timed from when it was due until its
last output is on the host, so a stall shows in every event it delays.
Every event due in the window is run, late ones included, up to a minute
past the window's close; one that never ran counts as missing.
``attempted`` and ``failed`` count events.

``tracer`` (``devtrace.Stretch``) profiles ``trace_events`` events from
40 % into the window, after one event that warms the profiler up."""

from __future__ import annotations

import time

from dabbench.calls import TRACE_AT, Event, now, run_event

PER_EVENT = True
#: how long after the window's close a late event may still start
LATE_LIMIT_S = 60.0
#: the last stretch before an event is due is spun, not slept: a sleep
#: on the card's host wakes up to half a millisecond late
SPIN_S = 0.003


def _sleep_until(t: float) -> None:
    while True:
        left = t - now()
        if left <= 0:
            return
        time.sleep(left - SPIN_S if left > 2 * SPIN_S else 0)


def drive(workload, caller, seconds: float, tracer=None):
    """Event k due at k * period from the start. Returns (events, window
    start, window end); an event that never ran has ``done`` None."""
    n = max(1, int(seconds / workload.period_s))
    trace_from = max(1, int(TRACE_AT * n)) if tracer else None
    events, t_start = [], now()
    for k in range(n):
        due = t_start + k * workload.period_s
        if now() > t_start + seconds + LATE_LIMIT_S:
            events.append(Event(k, due))
            continue
        if trace_from is not None and k == trace_from - 1:
            tracer.start()              # event k warms the profiler up
        if k == trace_from:
            tracer.begin()
        _sleep_until(due)
        ev = run_event(caller, workload, k, due)
        if trace_from is not None and \
                trace_from <= k < trace_from + workload.trace_events:
            ev.traced = True
            if k + 1 == min(n, trace_from + workload.trace_events):
                tracer.stop()
        events.append(ev)
    return events, t_start, t_start + n * workload.period_s
