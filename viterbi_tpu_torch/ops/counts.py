"""The launch counts of kernels A-D, I and J (I by its two entries,
codewords and superframes). Each wrapper adds one to its
``.launches`` where it launches its kernel, and nowhere else; a caller
sets them to 0 before a path and reads them after it, to show that the
path went through the kernels. Kernel A also counts its launches by
form (``acs_cuda.REGS_LAUNCHES``, by lanes a frame)."""

from __future__ import annotations

from . import acs_cuda, depuncture, rs
from . import traceback as tb

#: kernels A-D and J by their rows' names in chip_smoke.py's kernels line,
#: and kernel I's two entries (its row, ``rs_decode``, counts both)
KERNELS = {"acs_regs": (acs_cuda, "forward_regs"),
           "acs_words": (acs_cuda, "forward"),
           "tb_walk": (tb, "tb_walk"),
           "tb_words": (tb, "tb_words"),
           "rs_decode": (rs, "rs_decode_blocks"),
           "rs_superframes": (rs, "rs_check_superframes"),
           "depuncture": (depuncture, "depuncture")}


def zero_launches() -> None:
    for module, name in KERNELS.values():
        getattr(module, name).launches = 0
    for lanes in acs_cuda.REGS_LAUNCHES:
        acs_cuda.REGS_LAUNCHES[lanes] = 0


def regs_forms() -> dict:
    """Kernel A's launches by form so far: read before a stage and handed
    to ``acs_form`` after it."""
    return dict(acs_cuda.REGS_LAUNCHES)


def acs_form(before: dict) -> dict:
    """The counter ``acs_lanes`` of a stage: the lanes a frame of the form
    kernel A launched in since ``before`` (``regs_forms()``), the widest
    where it launched in several; no counter where it did not launch."""
    lanes = [k for k, n in acs_cuda.REGS_LAUNCHES.items()
             if n > before.get(k, 0)]
    return {"acs_lanes": max(lanes)} if lanes else {}


def launches() -> dict:
    """Launches of kernels A-D, I and J since ``zero_launches``."""
    return {k: getattr(m, n).launches for k, (m, n) in KERNELS.items()}


def total() -> int:
    """Launches of kernels A-D, I and J, all entries together: read before
    and after a stage, the stage's launches."""
    return sum([getattr(m, n).launches for m, n in KERNELS.values()])


def missing(counts: dict, names) -> list:
    """The kernels of ``names`` that ``counts`` shows never launched."""
    return [k for k in names if not counts.get(k)]
