"""L4 public API — the PyTorch/CUDA twin of the DLL export surface
(viterbi.def:4-8): ``deconvolve``, ``rs_check_superframe``,
``initialize``, ``get_caps``, ``wake_up``, plus the batched
``deconvolve_batch``.

Return-code contracts match the reference:
  * ``deconvolve`` returns 0 on success; 1 when the safe-mode latch is
    set or an input that would have crashed the reference is detected
    (exc_handler.cpp:150-250); decoded MSB-first packed bytes are
    written into ``output``.
  * ``rs_check_superframe`` returns the number of corrected byte
    errors, or -1 on an uncorrectable codeword or a crash
    (rschecksf.cpp:64-93); corrected data bytes go into ``out_vector``.
  * ``initialize`` re-reads the config and re-arms safe mode
    (dllmain.cpp:156-160).

No export needs ``initialize()`` first: the first call sets the
dispatcher up (``dispatch.ready``), as the reference does at load, on
the card, and raises ``placement.NoDeviceError`` where there is none
unless ``initialize(device="cpu")`` asked for the CPU. That raise is not
a decoder fault: it returns no error code and latches nothing.

Symbols arrive as host arrays, go to the device once per call
(``placement.ingest``), and the decoded bytes come back as numpy uint8;
``deconvolve_batch`` also takes an int32 tensor already on its device
(a resident batch), which it decodes there.
A one-frame ``deconvolve`` of integers on the card's fused rung replays
its size's CUDA graph from the size's second call on
(``runtime.frameplan``). Each export call is a span of
``runtime.calllog`` (``api.<export>``), with its stages ``ingest``,
``viterbi`` or ``rs``, and ``readback``; ``api.deconvolve`` counts
``graphed``, 1 where the call replayed a plan.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from . import constants as C
from .ops import acs, acs_cuda, counts
from .ops import rs as rs_ops
from .ops import traceback as tb
from .runtime import calllog, dispatch, faults, frameplan, placement

_SAFE = faults.SAFE_MODE_RETVAL


def _buf_len(buf) -> int:
    """Element count of an output buffer: ndarray .size, or len() for
    plain buffers (bytearray, memoryview, list)."""
    n = getattr(buf, "size", None)
    return len(buf) if n is None else int(n)


def _buf_write(buf, sl: slice, values: np.ndarray) -> None:
    """Assign uint8 values into ``buf[sl]`` for ndarrays and plain byte
    buffers alike (bytearray slice assignment takes bytes)."""
    if isinstance(buf, np.ndarray):
        buf[sl] = values
    else:
        buf[sl] = bytes(np.ascontiguousarray(values))


# Per-thread result channel: concurrent callers never read each other's
# results (the reference keeps decisions on the caller's stack).
_tls = threading.local()


def last_output() -> np.ndarray | None:
    """This thread's most recent ``deconvolve`` result (packed bytes)."""
    return getattr(_tls, "deco_out", None)


def last_rs_output() -> np.ndarray | None:
    """This thread's most recent ``rs_check_superframe`` output bytes."""
    return getattr(_tls, "rs_out", None)


def _ready(fn):
    """Set the dispatcher up at the export's first use, outside the fault
    guard, so that a missing card raises instead of latching."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        dispatch.ready()
        return fn(*args, **kwargs)
    return wrapper


def initialize(config_path: str | None = None, *, device=None) -> bool:
    """Re-init: clears the safe-mode latch, re-reads the config,
    re-probes the backend (building the kernels on first use). The
    device is ``device``, else the one chosen before, else the card
    (``placement.NoDeviceError`` where there is none). Drops every
    one-frame plan (``runtime.frameplan``)."""
    frameplan.CACHE.clear()
    return dispatch.initialize(config_path, device=device)


@_ready
def get_caps() -> int:
    """Backend capability bitmask (analog of GetCPUCaps)."""
    return dispatch.get_caps(dispatch.state().config.compile_cache)


#: Standard DAB audio bitrate ladder (kbit/s) warmed by
#: ``wake_up(ladder=True)`` — the shapes a channel-hopping receiver hits.
DAB_LADDER_KBPS = (8, 32, 64, 96, 128, 192, 384)


@_ready
def wake_up(framebits: int = 3072, batch: int = 1, ladder=False) -> None:
    """Warm the decode path — the analog of WakeUpYMM's pre-warming of
    cold SIMD stages (dllmain.cpp:45-56). Here the cold stages are the
    kernel build (first use) and the first launch of each shape.

    ``ladder=True`` warms every DAB bitrate in ``DAB_LADDER_KBPS`` at the
    given batch; an iterable of kbit/s rates warms exactly those."""
    if ladder is None or ladder is False:
        rates = None
    elif ladder is True:
        rates = DAB_LADDER_KBPS
    else:
        try:
            rates = tuple(int(k) for k in ladder)
        except TypeError:
            raise TypeError(
                "ladder must be a bool or an iterable of kbit/s rates, "
                f"got {ladder!r}") from None
    sizes = [framebits] if rates is None else [24 * k for k in rates]
    for fb in sizes:
        _decode_batch(np.zeros((batch, C.RATE * (fb + C.TAIL_BITS)),
                               dtype=np.int32), fb)


def _decode_arbitrary(syms: torch.Tensor, framebits: int) -> torch.Tensor:
    """Decode at any framebits, plain torch — the reference-contract path
    for sizes off the byte grid (chainback.inc:18-41 writes output[t>>3]
    per bit; a partial final byte holds the remaining bits MSB-aligned
    over zeros, see traceback.packbits_msb).

    Odd framebits: the reference's ACS loop runs floor((framebits+6)/2)
    step pairs (deconvolve.cpp:92), leaving the topmost decision word
    unwritten; this implements the well-defined idealization (the full
    framebits+6-step terminated trellis) that the golden oracle computes.
    """
    nsteps = framebits + C.TAIL_BITS
    syms = syms[:, : C.RATE * nsteps]
    if nsteps % 2:
        # one zero trailing step: decisions are causal, so those the
        # chainback reads (and the renorm cadence before them) are unchanged
        syms = torch.nn.functional.pad(syms, (0, C.RATE))
    decisions, _ = acs.forward(syms, nsteps + nsteps % 2)
    return tb.chainback_scan(decisions[:nsteps], framebits)


def _decode_tensor(syms: torch.Tensor, framebits: int, variant: str,
                   packed: bool = False,
                   block: int | None = None) -> torch.Tensor:
    """Decode symbols that already lie on the decode device through the
    named rung: [B, 4*(framebits+6)] symbols, or frame-major packed words
    int32[B, framebits+6] (``packed`` True or ``"bt"``, framebits % 8 ==
    0: every kernel and its plain version reads them in place). ``block``
    is the blocked traceback's block (default: the config key). Returns
    uint8[B, ceil(framebits/8)] on that device."""
    layout = "bt" if packed else False
    if framebits % 8:
        if packed:
            raise ValueError("off the byte grid the decode reads unpacked "
                             "symbols")
        return _decode_arbitrary(syms, framebits)
    if variant == "cuda_fused":
        # register-exchange ACS kernel + checkpoint-walk kernel
        return acs_cuda.decode(syms, framebits, packed=layout)
    st = dispatch.state()
    nsteps = framebits + C.TAIL_BITS
    block = tb.block_for(framebits, block or st.config.traceback_block)
    # the torch_* rungs are traceback strategies: their forward pass is the
    # decisions kernel wherever the kernels are built. On a CPU tensor
    # acs_cuda.forward is its plain version, which takes the same layouts.
    if variant == "cuda_words" or packed or st.caps & dispatch.CAP_KERNELS:
        decisions, _ = acs_cuda.forward(syms, nsteps, packed=layout)
    else:
        decisions, _ = acs.forward(syms, nsteps)
    if variant == "cuda_words" and framebits % tb.WORDS_WINDOW == 0:
        # decision-word walk kernel; the blocked traceback covers sizes
        # off the 24-bit window grid
        return tb.chainback_words_cuda(decisions, framebits)
    if variant == "torch_scan":
        return tb.chainback_scan(decisions, framebits)
    return tb.chainback_blocked(decisions, framebits, block=block)


def _decode_batch(symbols, framebits: int,
                  packed: bool = False) -> np.ndarray:
    """Dispatch a batch through the selected variant: [B, 4*(framebits+6)]
    symbols, or packed int32[B, framebits+6] words, which go to the device
    as they are wherever framebits % 8 == 0. Unpacked symbols on the byte
    grid go through ``placement.ingest_words``, which narrows a large
    batch to packed words on its way. An int32 tensor (a resident batch)
    is decoded where it lies, with no ingest. Returns uint8[B,
    ceil(framebits/8)] packed bytes on the host."""
    st = dispatch.state()
    variant = dispatch.VARIANTS[st.variant]
    resident = isinstance(symbols, torch.Tensor)
    if packed and framebits % 8:
        # off the byte grid the plain decode reads unpacked symbols: a
        # byte view of the words, where they lie
        if resident:
            symbols = symbols.contiguous().view(torch.uint8) \
                .reshape(symbols.shape[0], -1).to(torch.int32)
        else:
            symbols = np.ascontiguousarray(symbols, dtype=np.int32) \
                .view(np.uint8).reshape(symbols.shape[0], -1)
        packed = False
    if resident:
        syms = symbols
    elif packed or framebits % 8:
        syms = placement.ingest(symbols, st.device)
    else:
        syms, packed = placement.ingest_words(symbols, st.device)
    with counts.stage("viterbi"):
        out = _decode_tensor(syms, framebits, variant, packed)
    return _readback(out)


def _readback(out: torch.Tensor) -> np.ndarray:
    """A result on the decode device as a host array, in the span
    ``readback``: the wait for the card and the copy back, ``d2h_bytes``
    (on the CPU the bytes handed back, no copy)."""
    with calllog.span("readback") as sp:
        if sp:
            sp.count(d2h_bytes=out.numel() * out.element_size())
        return out.cpu().numpy()


@_ready
@faults.guarded(_SAFE)
def deconvolve(framebits: int, symbols, input_length: int = 0,
               output: np.ndarray | None = None) -> int:
    """Decode one frame. Signature mirrors the DLL export
    (viterbi.h:113); ``input_length`` is unused there too.

    ``symbols``: array-like of >= 4*(framebits+6) soft symbols (only the
    low byte of each is significant). ``output``: optional uint8 buffer
    of >= ceil(framebits/8) bytes, written in place. Any framebits in
    [1, MAX_FRAMEBITS] is accepted, as in the reference.
    """
    if symbols is None or framebits is None:
        # the reference would fault on the null deref inside the kernel
        raise faults.CrashError("null symbol buffer")
    framebits = int(framebits)
    if framebits <= 0 or framebits > C.MAX_FRAMEBITS:
        raise faults.ValidationError(f"bad framebits {framebits}")
    syms = np.asarray(symbols).reshape(-1)
    if syms.size < C.RATE * (framebits + C.TAIL_BITS):
        raise faults.ValidationError("symbol buffer too short")
    if output is not None and _buf_len(output) < -(-framebits // 8):
        raise faults.ValidationError("output buffer too short")
    with calllog.span("api.deconvolve") as call:
        syms = syms[: C.RATE * (framebits + C.TAIL_BITS)]
        call.record("deco", syms, source=symbols, framebits=framebits)
        out = frameplan.CACHE.decode(dispatch.state(), syms, framebits)
        if call:
            call.count(graphed=int(out is not None))
        if out is None:
            out = _decode_batch(syms[None, :], framebits)[0]
    if output is not None:
        _buf_write(output, slice(0, out.size), out)
    _tls.deco_out = out
    return 0


@_ready
@faults.guarded((_SAFE, None))
def deconvolve_batch(framebits: int, symbols_batch,
                     packed: bool = False) -> tuple[int, np.ndarray]:
    """Batched decode: [B, 4*(framebits+6)] -> (0, uint8[B, ceil(fb/8)]).

    ``packed=True`` accepts the host-packed one-int32-per-trellis-step
    layout instead (int32[B, >= framebits+6], symbol j in byte j —
    ``ops.acs_cuda.pack_symbols_host``): a byte reinterpret of the DAB
    symbol stream that ships 4x fewer bytes per call, the production
    ingest path. Where framebits % 8 == 0 the words go to the device as
    they are and every rung's forward kernel reads them in place; off the
    byte grid the plain decode reads a host byte view of them.

    ``symbols_batch`` may also be an int32 torch tensor, on a card or on
    the CPU, unpacked or packed: a resident batch, decoded where it lies
    through the selected rung, with no copy up and no ``ingest`` stage.
    The output is a host array as for any other input. The root span
    counts ``resident``, 1 for a tensor and 0 for a host array.
    """
    if symbols_batch is None:
        raise faults.CrashError("null symbol buffer")
    framebits = int(framebits)
    if framebits <= 0 or framebits > C.MAX_FRAMEBITS:
        raise faults.ValidationError(f"bad framebits {framebits}")
    resident = isinstance(symbols_batch, torch.Tensor)
    if resident and symbols_batch.dtype != torch.int32:
        raise faults.ValidationError(
            f"a resident batch is int32, got {symbols_batch.dtype}")
    syms = symbols_batch if resident else np.asarray(symbols_batch)
    width = ((framebits + C.TAIL_BITS) if packed
             else C.RATE * (framebits + C.TAIL_BITS))
    if syms.ndim != 2 or syms.shape[1] < width:
        raise faults.ValidationError("bad symbol batch shape")
    with calllog.span("api.deconvolve_batch") as call:
        syms = syms[:, :width]
        call.record("deco", syms, source=symbols_batch,
                    framebits=framebits, batch=syms.shape[0],
                    packed=int(packed))
        if call:
            call.count(resident=int(resident))
        out = _decode_batch(syms, framebits, packed=packed)
    return 0, out


def _byte_view(buf) -> np.ndarray | None:
    """A writable uint8 array over the caller's buffer: the ndarray
    itself, or a view of a ``bytearray`` or ``memoryview``; None for an
    object without the buffer protocol (a list)."""
    if isinstance(buf, np.ndarray):
        return buf
    try:
        return np.frombuffer(buf, dtype=np.uint8)
    except TypeError:
        return None


def _write_prefix(out_vector, out: np.ndarray, rs_dims: int,
                  n_ok: int) -> None:
    """The -1 partial write: the ``n_ok`` codewords before the first
    failure go to their interleaved places (byte k of codeword j at
    ``j + k*rs_dims``) in one assignment; every other byte of the
    caller's buffer stays as it was."""
    idx = (np.arange(C.RS_KK)[:, None] * rs_dims
           + np.arange(n_ok)[None, :]).ravel()
    vals = out[idx]
    view = _byte_view(out_vector)
    if view is None:
        # no buffer to view (a list): read, patch, write back one slice
        end = rs_dims * C.RS_KK
        patched = np.array(out_vector[:end], dtype=np.uint8)
        patched[idx] = vals
        _buf_write(out_vector, slice(0, end), patched)
    elif view.ndim == 1:
        view[idx] = vals
    else:
        # flat positions unraveled onto the array itself: reshape(-1) of
        # a non-contiguous view would copy and lose the write
        view[np.unravel_index(idx, view.shape)] = vals


@_ready
@faults.guarded(-1)
def rs_check_superframe(p, start_ix: int = 0, rs_dims: int = 0,
                        out_vector=None) -> int:
    """Check/correct a DAB+ superframe (rschecksf.cpp:64-93).

    ``p``: array-like of rs_dims*120 bytes, byte-interleaved. The
    corrected rs_dims*110 data bytes are written to ``out_vector`` if
    given (an ndarray of any contiguity, a ``bytearray`` or a writable
    ``memoryview``) and kept per thread for ``last_rs_output()``.
    ``start_ix`` is accepted and ignored, as in the reference
    (rschecksf.cpp:69).

    On -1 (uncorrectable codeword) the reference has already scattered
    every corrected codeword before the failed one into the caller's
    buffer (rschecksf.cpp:74-88); bytes of the failed and later codewords
    stay untouched. The same partial write happens here.
    """
    if p is None:
        # fault injection (c): RScheckSuperframe(NULL, 0, 10, NULL)
        raise faults.CrashError("null superframe buffer")
    if not rs_dims or rs_dims < 0:
        raise faults.ValidationError(f"bad rs_dims {rs_dims}")
    rs_dims = int(rs_dims)
    buf = np.asarray(p).reshape(-1)
    if buf.size < rs_dims * C.RS_N:
        raise faults.ValidationError("superframe buffer too short")
    if out_vector is not None and \
            _buf_len(out_vector) < rs_dims * C.RS_KK:
        raise faults.ValidationError("output buffer too short")
    with calllog.span("api.rs_check_superframe") as call:
        buf = buf[: rs_dims * C.RS_N]
        call.record("rscs", buf, source=p, rs_dims=rs_dims)
        sf = placement.ingest(buf, dispatch.state().device, torch.uint8)
        # one launch into one buffer, one copy back
        back, views = rs_ops.superframe_buffer(rs_dims, sf.device)
        with counts.stage("rs"):
            rs_ops.rs_check_superframes(sf[None], rs_dims,
                                        zero_after_fail=True, out=views)
        errors, out, n_ok = rs_ops.unpack_superframe_buffer(
            _readback(back), rs_dims)
    if out_vector is not None:
        if errors != -1:
            _buf_write(out_vector, slice(0, out.size), out)
        else:
            _write_prefix(out_vector, out, rs_dims, n_ok)
    _tls.rs_out = out
    return errors
