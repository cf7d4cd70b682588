"""ingest.h2d_bytes_per_bit.bulk (B/bit): bytes the traced stretch copied
from host to device (the profiler's copies) over the data bits its calls
decoded."""

from dabbench import readers


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.ops(cat="gpu_memcpy", pattern=readers.HTOD)
    if not ops or any("bytes" not in o.args for o in ops):
        return None
    bits = sum(c.bits for c in readers.traced_calls(run))
    return sum(float(o.args["bytes"]) for o in ops) / bits if bits else None
