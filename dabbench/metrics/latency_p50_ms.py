"""latency_p50_ms (ms): the median over the same events as
latency_p95_ms."""

import numpy as np

from dabbench import readers


def read(run):
    lat = readers.latencies_ms(run)
    return float(np.percentile(lat, 50)) if lat.size else None
