"""latency_p95_ms (ms): the 95th percentile over all events of the
window, each from its due time to its last output on the host."""

import numpy as np

from dabbench import readers


def read(run):
    lat = readers.latencies_ms(run)
    return float(np.percentile(lat, 95)) if lat.size else None
