"""kernel.acs_regs_roofline.bulk (%): kernel A's least time for the
traced calls' frames (roofline.acs_regs_bound) over its device time in
the trace."""

from dabbench import readers


def read(run):
    t = readers.device_seconds(run, readers.ACS_REGS)
    return readers.share_pct(readers.acs_regs_bound_s(run), t) if t else None
