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

Symbols arrive as host arrays, go to the device once per call, and the
decoded bytes come back as numpy uint8.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import constants as C
from .ops import acs, acs_cuda
from .ops import rs as rs_ops
from .ops import traceback as tb
from .runtime import calllog, dispatch, faults

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


def initialize(config_path: str | None = None) -> bool:
    """Re-init: clears the safe-mode latch, re-reads the config,
    re-probes the backend (building the kernels on first use)."""
    ok = dispatch.initialize(config_path)
    cfg = dispatch.state().config
    calllog.configure(cfg.log_calls, cfg.log_symbols)
    return ok


def get_caps() -> int:
    """Backend capability bitmask (analog of GetCPUCaps)."""
    return dispatch.get_caps(dispatch.state().config.compile_cache)


#: Standard DAB audio bitrate ladder (kbit/s) warmed by
#: ``wake_up(ladder=True)`` — the shapes a channel-hopping receiver hits.
DAB_LADDER_KBPS = (8, 32, 64, 96, 128, 192, 384)


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


def _block(framebits: int, block: int) -> int:
    """The blocked traceback's block: ``block`` (config key
    ``traceback_block``) where it divides framebits, else the largest
    of 64, 48, 32, 24, 16, 8, 4, 2, 1 that does."""
    if framebits % block == 0:
        return block
    return next(b for b in (64, 48, 32, 24, 16, 8, 4, 2, 1)
                if framebits % b == 0)


def _decode_tensor(syms: torch.Tensor, framebits: int, variant: str,
                   packed: bool = False) -> torch.Tensor:
    """Decode symbols that already lie on the decode device through the
    named rung: [B, 4*(framebits+6)] symbols, or frame-major packed words
    (``packed=True``, ``cuda_fused`` only). Returns uint8[B,
    ceil(framebits/8)] on that device."""
    if variant == "cuda_fused" and framebits % 8 == 0:
        # register-exchange ACS kernel + checkpoint-walk kernel
        return acs_cuda.decode(syms, framebits,
                               packed="bt" if packed else False)
    if packed:
        raise ValueError(f"{variant} reads unpacked symbols")
    if framebits % 8:
        return _decode_arbitrary(syms, framebits)
    st = dispatch.state()
    nsteps = framebits + C.TAIL_BITS
    block = _block(framebits, st.config.traceback_block)
    if variant == "cuda_words":
        # decisions kernel + decision-word walk kernel; the blocked
        # traceback covers sizes off the 24-bit window grid
        decisions, _ = acs_cuda.forward(syms, nsteps)
        if framebits % tb.WORDS_WINDOW == 0:
            return tb.chainback_words_cuda(decisions, framebits)
        return tb.chainback_blocked(decisions, framebits, block=block)
    # the torch_* rungs are traceback strategies: their forward pass is
    # the decisions kernel wherever the kernels are built
    if st.caps & dispatch.CAP_KERNELS:
        decisions, _ = acs_cuda.forward(syms, nsteps)
    else:
        decisions, _ = acs.forward(syms, nsteps)
    if variant == "torch_blocked":
        return tb.chainback_blocked(decisions, framebits, block=block)
    return tb.chainback_scan(decisions, framebits)


def _decode_batch(symbols: np.ndarray, framebits: int,
                  packed: bool = False) -> np.ndarray:
    """Dispatch a batch through the selected variant: [B, 4*(framebits+6)]
    symbols, or packed int32[B, framebits+6] words. Returns
    uint8[B, ceil(framebits/8)] packed bytes."""
    st = dispatch.state()
    variant = dispatch.VARIANTS[st.variant]
    if packed and not (variant == "cuda_fused" and framebits % 8 == 0):
        # the other rungs read unpacked symbols: a host byte view
        symbols = np.ascontiguousarray(symbols, dtype=np.int32) \
            .view(np.uint8).reshape(symbols.shape[0], -1)
        packed = False
    syms = torch.from_numpy(np.ascontiguousarray(symbols, dtype=np.int32)) \
        .to(st.device)
    return _decode_tensor(syms, framebits, variant, packed).cpu().numpy()


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
    with calllog.record("deco", framebits=framebits) as rec:
        syms = syms[: C.RATE * (framebits + C.TAIL_BITS)]
        rec.capture_symbols(syms, source=symbols)
        out = _decode_batch(syms[None, :], framebits)[0]
    if output is not None:
        _buf_write(output, slice(0, out.size), out)
    _tls.deco_out = out
    return 0


@faults.guarded((_SAFE, None))
def deconvolve_batch(framebits: int, symbols_batch,
                     packed: bool = False) -> tuple[int, np.ndarray]:
    """Batched decode: [B, 4*(framebits+6)] -> (0, uint8[B, ceil(fb/8)]).

    ``packed=True`` accepts the host-packed one-int32-per-trellis-step
    layout instead (int32[B, >= framebits+6], symbol j in byte j —
    ``ops.acs_cuda.pack_symbols_host``): a byte reinterpret of the DAB
    symbol stream that ships 4x fewer bytes per call, the production
    ingest path. The fused kernel reads it in place; the other rungs
    unpack it with a host byte view.
    """
    if symbols_batch is None:
        raise faults.CrashError("null symbol buffer")
    framebits = int(framebits)
    if framebits <= 0 or framebits > C.MAX_FRAMEBITS:
        raise faults.ValidationError(f"bad framebits {framebits}")
    syms = np.asarray(symbols_batch)
    width = ((framebits + C.TAIL_BITS) if packed
             else C.RATE * (framebits + C.TAIL_BITS))
    if syms.ndim != 2 or syms.shape[1] < width:
        raise faults.ValidationError("bad symbol batch shape")
    with calllog.record("deco", framebits=framebits, batch=syms.shape[0],
                        packed=int(packed)) as rec:
        syms = syms[:, :width]
        rec.capture_symbols(syms, source=symbols_batch)
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
    with calllog.record("rscs", rs_dims=rs_dims) as rec:
        buf = buf[: rs_dims * C.RS_N]
        rec.capture_symbols(buf, source=p)
        sf = torch.from_numpy(np.ascontiguousarray(buf, dtype=np.int32)) \
            .to(dispatch.state().device)
        errors, out, n_ok = rs_ops.rs_check_superframe(sf, rs_dims)
        errors, n_ok, out = int(errors), int(n_ok), out.cpu().numpy()
    if out_vector is not None:
        if errors != -1:
            _buf_write(out_vector, slice(0, out.size), out)
        else:
            _write_prefix(out_vector, out, rs_dims, n_ok)
    _tls.rs_out = out
    return errors
