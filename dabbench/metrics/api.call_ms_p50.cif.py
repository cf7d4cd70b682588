"""api.call_ms_p50.cif (ms): median wall time of one deconvolve call (one
frame in, its bytes written) over the calls outside the traced stretch
(the benchmark's spans)."""

import numpy as np

from dabbench import readers


def read(run):
    ms = readers.call_ms(run, "deconvolve")
    return float(np.median(ms)) if ms.size else None
