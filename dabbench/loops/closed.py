"""The closed loop: one caller, each event as soon as the last is done,
until the window's seconds have passed; a rate is the work of all events
over all their time. ``attempted`` and ``failed`` count calls.

``tracer`` (``devtrace.Stretch``) profiles ``trace_events`` events from
40 % into the window, after one event that warms the profiler up."""

from __future__ import annotations

from dabbench.calls import TRACE_AT, now, run_event

PER_EVENT = False


def drive(workload, caller, seconds: float, tracer=None):
    """Events back to back until ``seconds`` have passed. Returns (events,
    window start, window end)."""
    events, k, t_start = [], 0, now()
    trace_from = None
    while True:
        if tracer and trace_from is None and \
                now() - t_start >= TRACE_AT * seconds:
            trace_from = k + 1          # event k warms the profiler up
            tracer.start()
        if k == trace_from:
            tracer.begin()
        ev = run_event(caller, workload, k, now())
        if trace_from is not None and \
                trace_from <= k < trace_from + workload.trace_events:
            ev.traced = True
            if k + 1 == trace_from + workload.trace_events:
                tracer.stop()
        events.append(ev)
        k += 1
        if now() - t_start >= seconds and \
                (tracer is None or tracer.done):
            break
    return events, t_start, events[-1].done
