"""kernel.depuncture_roofline.punctured (%): kernel J's least time for the
traced calls' frames (roofline_depuncture.depuncture_bound: the kept bytes
read and the mother-code bytes written at the memory rate) over its
device time in the trace."""

from dabbench import readers, roofline_depuncture

KERNEL_J = r"depuncture_kernel"


def read(run):
    t = readers.device_seconds(run, KERNEL_J)
    if not t:
        return None
    bound = 0.0
    for c in readers.traced_calls(run):
        pool = run.workload.pools[c.pool]
        if c.frames:
            bound += roofline_depuncture.depuncture_bound(
                c.frames, pool.kbps, pool.protection)
    return readers.share_pct(bound, t)
