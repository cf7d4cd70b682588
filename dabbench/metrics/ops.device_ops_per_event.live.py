"""ops.device_ops_per_event.live (ops/event): the device operations
(kernels, copies, memsets) of the traced stretch over its events."""


def read(run):
    events = run.traced_events()
    if run.trace is None or not run.trace.device or not events:
        return None
    return len(run.trace.device) / len(events)
