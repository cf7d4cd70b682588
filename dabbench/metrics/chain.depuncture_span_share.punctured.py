"""chain.depuncture_span_share.punctured (%): share of the traced window
covered by the program's ``depuncture`` stage (the union of its host
spans ``viterbi_tpu_torch.depuncture`` on the profiler's timeline)."""

from dabbench import devtrace

SPAN = "viterbi_tpu_torch.depuncture"


def read(run):
    if run.trace is None:
        return None
    w0, w1 = run.trace.window
    spans = [(max(o.t0, w0), min(o.t1, w1)) for o in run.trace.host
             if o.name == SPAN and o.t1 > w0 and o.t0 < w1]
    t = sum(b - a for a, b in devtrace.union(spans))
    return 100.0 * t / run.trace.window_s if t else None
