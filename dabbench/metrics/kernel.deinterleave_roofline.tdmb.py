"""kernel.deinterleave_roofline.tdmb (%): kernel K's least time for the
traced calls (roofline_tdmb.deinterleave_bound: each call's decoded bytes
read and its codewords written once, with the streams' FIFOs, at the
memory rate) over its device time in the trace."""

from dabbench import readers, roofline_tdmb

KERNEL_K = r"deinterleave_kernel"


def read(run):
    t = readers.device_seconds(run, KERNEL_K)
    if not t:
        return None
    bound = sum(roofline_tdmb.deinterleave_bound(
        c, run.workload.pools[c.pool].kbps)
        for c in readers.traced_calls(run) if getattr(c, "streams", 0))
    return readers.share_pct(bound, t)
