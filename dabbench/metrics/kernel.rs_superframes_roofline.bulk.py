"""kernel.rs_superframes_roofline.bulk (%): kernel I's least time on the
superframes of the traced chain calls (roofline.rs_superframes_bound)
over its device time in the trace."""

from dabbench import readers


def read(run):
    t = readers.device_seconds(run, readers.RS_SUPERFRAMES)
    return readers.share_pct(readers.rs_superframes_bound_s(run), t) \
        if t else None
