"""ingest.h2d_share.bulk (%): share of the traced window in which a copy
from host to device ran."""

from dabbench import devtrace, readers


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.ops(cat="gpu_memcpy", pattern=readers.HTOD)
    t = sum(b - a for a, b in devtrace.union([(o.t0, o.t1) for o in ops]))
    return 100.0 * t / run.trace.window_s if t else None
