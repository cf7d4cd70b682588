"""kernel.acs_regs.us_per_step.live (us): kernel A's device time in the
trace over the trellis steps (framebits + 6) of the traced calls that
launch it, one launch a call: its serial cost a step."""

from dabbench import readers


def read(run):
    t = readers.device_seconds(run, readers.ACS_REGS)
    steps = sum(run.workload.pools[c.pool].framebits + readers.TAIL_BITS
                for c in readers.traced_calls(run) if c.frames)
    return 1e6 * t / steps if t and steps else None
