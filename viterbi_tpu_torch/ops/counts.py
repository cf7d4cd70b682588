"""The launch counts of kernels A-D and I-K (I by its three entries,
codewords, superframes and RS(204,188) packets), read from the launch
path: each
``_build.Kernel`` adds one to its tally where the card accepts a launch
(kernel A's by form, its lanes a frame), and nothing else counts. A
caller sets them to 0 before a path and reads them after it, to show
that the path went through the kernels (``only``); ``stage`` is a traced
stage of a call that records its launches."""

from __future__ import annotations

from ..runtime import calllog
from . import _build

#: kernels A-D and J by their rows' names in chip_smoke.py's kernels line,
#: kernel I's three entries (its row, ``rs_decode``, counts the first two)
#: and kernel K
KERNELS = {k.name: k for k in (
    _build.ACS_REGS, _build.ACS_WORDS, _build.TB_WALK, _build.TB_WORDS,
    _build.RS_DECODE, _build.RS_SUPERFRAMES, _build.DEPUNCTURE,
    _build.RS_PACKETS, _build.DEINTERLEAVE)}


def zero_launches() -> None:
    for kernel in KERNELS.values():
        kernel.zero()


def launches() -> dict:
    """Launches of kernels A-D and I-K since ``zero_launches``."""
    return {name: k.launches for name, k in KERNELS.items()}


def total() -> int:
    """Launches of kernels A-D and I-K, all entries together: read before
    and after a stage, the stage's launches."""
    return sum([k.launches for k in KERNELS.values()])


def missing(counts: dict, names) -> list:
    """The kernels of ``names`` that ``counts`` shows never launched."""
    return [k for k in names if not counts.get(k)]


def only(expected: dict, counts: dict | None = None) -> bool:
    """Whether ``counts`` (default: ``launches()``) shows exactly the
    launches ``expected`` names and none of every other kernel."""
    unknown = set(expected) - set(KERNELS)
    if unknown:
        raise ValueError(f"no kernel named {sorted(unknown)}")
    if counts is None:
        counts = launches()
    return counts == {k: expected.get(k, 0) for k in KERNELS}


class _Stage:
    """A traced stage: its span, and the launches when it opened."""
    __slots__ = ("span", "n0", "forms0")

    def __init__(self, span):
        self.span = span

    def __enter__(self):
        sp = self.span.__enter__()
        self.n0 = total()
        self.forms0 = dict(_build.ACS_REGS.tally)
        return sp

    def __exit__(self, *exc):
        if exc[0] is None:
            forms = [k for k, n in _build.ACS_REGS.tally.items()
                     if n > self.forms0[k]]
            self.span.count(launches=total() - self.n0)
            if forms:
                self.span.count(acs_lanes=max(forms))
        return self.span.__exit__(*exc)


def stage(name: str):
    """``calllog.span(name)`` around one stage of a call; the ``with``
    hands back the span, for the caller's own counters. While tracing is
    on the span gets, at its end, the counter ``launches`` (the kernels'
    launches inside it) and, where kernel A launched, ``acs_lanes`` (the
    lanes a frame of its form, the widest where it launched in several);
    off, it is the span's shared no-op object and counts nothing."""
    sp = calllog.span(name)
    return _Stage(sp) if sp else sp
