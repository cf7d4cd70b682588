"""Failure detection & recovery — the analog of the reference's
vectored-exception-handler subsystem (exc_handler.cpp:150-250).

The reference survives access violations inside its kernels by patching
the fault away and latching the dispatcher to a safe no-op decoder until
``initialize()`` re-arms it. Here:

  * input validation before dispatch, split into two classes the way
    the reference's address-range attribution splits faults
    (exc_handler.cpp:195,229-231):
      - ``CrashError`` — inputs that would have faulted inside the
        reference's kernels (null buffers): return the error code AND
        latch safe mode;
      - ``ValidationError`` — benign caller typos (bad framebits, short
        buffers): return the error code WITHOUT latching;
  * a catch-all around kernel execution that converts any other device
    or host exception into the latch-and-degrade behavior,
  * ``initialize()`` clears the latch (runtime.dispatch.initialize).

``guarded`` is the decorator the hot API entry points go through. A
missing card is not a decoder fault: ``placement.NoDeviceError`` passes
through the guard, and latches nothing.
"""

from __future__ import annotations

import functools
import threading
import traceback as _tb

from . import dispatch
from .placement import NoDeviceError

SAFE_MODE_RETVAL = 1   # decon_savemode's return value (viterbi_helpers.asm)

_last_fault: dict = {"exc": None, "trace": None, "count": 0}
_fault_lock = threading.Lock()


def last_fault() -> dict:
    with _fault_lock:
        return dict(_last_fault)


def record_fault(exc: BaseException) -> None:
    with _fault_lock:
        _last_fault["exc"] = repr(exc)
        _last_fault["trace"] = _tb.format_exc()
        _last_fault["count"] += 1
    dispatch.latch_safe_mode(exc)


def guarded(safe_retval):
    """Wrap an API entry point with validation + latch-on-fault.

    While safe mode is latched, calls return ``safe_retval`` immediately
    (viterbi-benchmark.cpp:456-464). ``ValidationError`` returns the
    error code without latching; ``NoDeviceError`` raises; everything
    else latches.
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if dispatch.state().safe_mode:
                return safe_retval
            try:
                return fn(*args, **kwargs)
            except ValidationError:   # benign typo: error, no latch
                return safe_retval
            except NoDeviceError:     # no card: the caller's to handle
                raise
            except Exception as exc:  # kernel fault: latch, survive
                record_fault(exc)
                return safe_retval
        return wrapper
    return deco


class ValidationError(ValueError):
    """Benign bad input (shape/size typo): error return, no latch."""


class CrashError(RuntimeError):
    """Input that would have faulted inside the reference's kernels
    (null pointers): error return + safe-mode latch."""
