"""chain.outer_span_share.tdmb (%): share of the traced window covered by
the T-DMB chain's outer stages: the union of the program's
``deinterleave`` and ``rs`` spans (``viterbi_tpu_torch.deinterleave``,
``viterbi_tpu_torch.rs`` on the profiler's timeline) that lie inside its
``viterbi_tpu_torch.tdmb`` spans."""

from dabbench import devtrace

ROOT = "viterbi_tpu_torch.tdmb"
STAGES = ("viterbi_tpu_torch.deinterleave", "viterbi_tpu_torch.rs")


def read(run):
    if run.trace is None:
        return None
    w0, w1 = run.trace.window
    roots = [(o.t0, o.t1) for o in run.trace.host if o.name == ROOT]
    spans = [(max(o.t0, w0), min(o.t1, w1)) for o in run.trace.host
             if o.name in STAGES and o.t1 > w0 and o.t0 < w1
             and any(a <= o.t0 and o.t1 <= b for a, b in roots)]
    t = sum(b - a for a, b in devtrace.union(spans))
    return 100.0 * t / run.trace.window_s if t else None
