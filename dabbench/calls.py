"""The record of every call, and the caller that makes it.

Each call goes to the entry adapter that the cell names for its role
(``entries/<name>.py``), on the side that answers in this run: the
program under test (``answers.Program``) or, for the control, the plain
reference (``answers.Table``). It is timed on the host, from the call to
its outputs on the host, and wrapped in a span of the benchmark's own
(``record_function("dabbench.<entry>")``), the spans the traced run
reads. The loops that schedule the calls are ``loops/<loop>.py``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
from torch.profiler import record_function

#: share of the window before the traced stretch
TRACE_AT = 0.4
now = time.perf_counter


@dataclasses.dataclass
class Record:
    call: object
    entry: str = ""
    out: object = None
    t0: float = 0.0
    t1: float = 0.0
    error: str | None = None


@dataclasses.dataclass
class Event:
    k: int
    due: float
    done: float | None = None
    records: list = dataclasses.field(default_factory=list)
    traced: bool = False


@dataclasses.dataclass
class Sample:
    """Rows of a large output, drawn from the seed, and its shape: what is
    kept of it for the comparison, so the window holds no output it has
    done with (a user consumes each one)."""
    shape: tuple
    rows: np.ndarray
    values: np.ndarray


#: outputs larger than this keep a sample of their rows
KEEP_BYTES = 1 << 20
#: the share of a large output's rows kept, and the least number
SAMPLE_SHARE, SAMPLE_MIN = 16, 64


class Caller:
    """Runs a workload's calls through its entry adapters on one side
    (``answers.Program`` or ``answers.Table``). ``state`` is what the
    adapters keep between the calls of one run (the frames decoded for a
    subchannel's superframe check). Of an output over ``KEEP_BYTES`` it
    keeps a sample of rows drawn from ``seed``."""

    def __init__(self, workload, side, seed: int = 0):
        self.w, self.side = workload, side
        self.state: dict = {}
        self.rng = np.random.default_rng(seed)

    def __call__(self, call) -> Record:
        name, entry = self.w.entries[call.role]
        answer = getattr(entry, self.side.SIDE)
        rec = Record(call, name)
        pool = self.w.pools[call.pool]
        with record_function(f"dabbench.{name}"):
            rec.t0 = now()
            try:
                out = answer(self.side, pool, call, self.state)
                rec.t1 = now()
                rec.out = tuple(self._keep(x) for x in out)
            except Exception as exc:          # counted as failed
                rec.t1 = now()
                rec.error = f"{type(exc).__name__}: {exc}"
        return rec

    def _keep(self, x):
        if not isinstance(x, np.ndarray) or x.nbytes <= KEEP_BYTES:
            return x
        n = x.shape[0]
        k = min(n, max(SAMPLE_MIN, n // SAMPLE_SHARE))
        rows = np.sort(self.rng.choice(n, k, replace=False))
        return Sample(x.shape, rows, x[rows])


def run_event(caller, workload, k, due) -> Event:
    """Event ``k``'s calls in order; done when the last output is on the
    host."""
    ev = Event(k, due)
    for call in workload.event(k):
        ev.records.append(caller(call))
    ev.done = now()
    return ev
