"""chain.call_ms_p50.live (ms): median wall time of one
decode_audio_superframes call, symbols in to audio and counts on the
host, over the calls outside the traced stretch (the benchmark's spans)."""

import numpy as np

from dabbench import readers


def read(run):
    ms = readers.call_ms(run, "decode_audio_superframes")
    return float(np.median(ms)) if ms.size else None
