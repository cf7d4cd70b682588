"""kernel.rs_packets_roofline.tdmb (%): kernel I's RS(204,188) entry's
least time for the traced calls' codewords (roofline_tdmb.
rs_packets_bound: bytes at the memory rate, syndromes on the int8 tensor
cores) over its device time in the trace."""

from dabbench import readers, roofline_tdmb

KERNEL_I_PACKETS = r"rs_packets_kernel"


def read(run):
    t = readers.device_seconds(run, KERNEL_I_PACKETS)
    if not t:
        return None
    bound = sum(roofline_tdmb.rs_packets_bound(
        c, run.workload.pools[c.pool].kbps, run.card["clock_max_sm_hz"])
        for c in readers.traced_calls(run) if getattr(c, "streams", 0))
    return readers.share_pct(bound, t)
