"""The CUDA forward passes: the port of ``viterbi_tpu.ops.acs_pallas``.

``forward`` is the decisions kernel's wrapper: the trellis with every
step's decisions written out as the reference's two decision words. On a
CUDA tensor it launches kernel C (``csrc/acs_words.cu``); on a CPU tensor
it runs ``forward_plain``, which is ``ops.acs.forward`` after unpacking
the packed layouts.

``forward_regs`` runs the trellis while every state carries a 32-bit
register of its survivor path's last input bits, and writes the
registers out every ``ckpt`` steps. The traceback then walks one
checkpoint per step (``traceback.chainback_regs_cuda``) instead of one
decision per bit. On a CUDA tensor ``forward_regs`` launches kernel A
(``csrc/acs_regs.cu``); on a CPU tensor it runs ``forward_regs_plain``.

Layout for the H100. The TPU path tiled the batch and the trellis time
into a grid and padded the front of the trellis so that the chunks came
out even (``choose_layout``, ``_batch_tile``). Kernel A gives each frame
one thread that walks the whole trellis, so there are no chunks to even
out: ``decode`` runs the natural trellis with ``DECODE_CKPT`` = 24 and no
front pad, and the last checkpoint is partial when 24 does not divide
the trellis length. That makes every byte-aligned frame size decodable.
Checkpoints dominate the kernel's memory traffic (256 bytes per frame
per checkpoint, against 4 bytes of symbols per step), so the period is
the longest for which every output byte still lies inside one 32-bit
register (``traceback._regs_bytes``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import constants as C
from . import _build
from . import acs as acs_ops
from . import traceback as tb

DECODE_CKPT = 24   # checkpoint period of decode(); see the module docstring
ACS_THREADS = 64   # frames per block of kernel A
WORDS_THREADS = 64  # frames per block of kernel C


def pack_symbols(symbols: torch.Tensor, nsteps: int) -> torch.Tensor:
    """[B, >=4*nsteps] soft symbols -> time-major packed [nsteps, B] int32:
    one trellis step's four symbols in one word, symbol j in byte j."""
    s = symbols[:, : 4 * nsteps].to(torch.int32) & 0xFF
    s = s.reshape(symbols.shape[0], nsteps, 4)
    packed = s[..., 0] | (s[..., 1] << 8) | (s[..., 2] << 16) \
        | (s[..., 3] << 24)
    return packed.T


def pack_symbols_host(symbols: np.ndarray) -> np.ndarray:
    """Host-side packing: [B, 4T] soft symbols (values 0..255 in any
    integer dtype) -> [B, T] int32, one trellis step per word. The DAB
    symbol stream arrives as consecutive bytes s0 s1 s2 s3 per step, so
    this is a little-endian byte reinterpret with no arithmetic."""
    b, s4 = symbols.shape
    assert s4 % 4 == 0
    a = np.ascontiguousarray(symbols) if symbols.dtype == np.uint8 \
        else np.ascontiguousarray(symbols.astype(np.uint8))
    return a.view(np.int32).reshape(b, s4 // 4)


def choose_ckpt(nsteps: int) -> int:
    """Default checkpoint period of ``forward_regs``: the largest even
    period <= 26 dividing nsteps, multiples of 6 first — the TPU
    package's choice wherever that choice divides nsteps. Where no even
    period does (e.g. framebits 32, nsteps 38), 24 with a partial last
    checkpoint: the TPU package fell back to 6 there and then rejected
    the layout."""
    if nsteps % 6 == 0:
        for d in (24, 18, 12, 6):
            if nsteps % d == 0:
                return d
    for d in range(26, 5, -2):
        if nsteps % d == 0:
            return d
    return 24


def _check_nsteps(nsteps: int) -> None:
    """The trellis runs in step pairs (the renormalization cadence)."""
    if nsteps <= 0 or nsteps % 2:
        raise ValueError(f"nsteps must be positive and even, got {nsteps}")


def _layout(nsteps: int, ckpt: int | None, front_pad: int):
    """(total steps, ckpt, checkpoint count, reset step or -1)."""
    _check_nsteps(nsteps)
    if front_pad < 0 or front_pad % 2:
        raise ValueError(f"front_pad must be even and >= 0, got {front_pad}")
    total = nsteps + front_pad
    if ckpt is None:
        ckpt = choose_ckpt(total)
    if not 2 <= ckpt <= 26 or ckpt % 2:
        raise ValueError(f"ckpt must be even and in [2, 26], got {ckpt}")
    return total, ckpt, -(-total // ckpt), front_pad if front_pad else -1


def _batch(symbols: torch.Tensor, nsteps: int, packed) -> int:
    """Frame count of a symbol tensor in the given layout; checks the
    step extent."""
    if symbols.dim() != 2:
        raise ValueError(f"symbols must be 2-D, got {list(symbols.shape)}")
    if packed == "bt":
        B, steps = symbols.shape
    elif packed:
        steps, B = symbols.shape
    else:
        B, steps = symbols.shape[0], symbols.shape[1] // C.RATE
    if steps < nsteps:
        raise ValueError(f"symbols cover {steps} steps, need {nsteps}")
    return B


def _strided(symbols: torch.Tensor, packed):
    """(int32 symbols, frame stride, step stride, unpacked flag): where a
    kernel finds frame b's step-u symbols in the given layout."""
    sym = symbols.to(torch.int32)
    if packed == "bt":
        return sym, sym.stride(0), sym.stride(1), 0
    if packed:
        return sym, sym.stride(1), sym.stride(0), 0
    if sym.stride(1) != 1:
        sym = sym.contiguous()
    return sym, sym.stride(0), C.RATE, 1


def unpack_symbols(symbols: torch.Tensor, nsteps: int,
                   packed: bool | str) -> torch.Tensor:
    """Symbols in any ``forward`` layout -> [B, 4*nsteps] int32 soft
    symbols, symbol j of a step from byte j of its packed word."""
    if not packed:
        return symbols[:, : C.RATE * nsteps].to(torch.int32)
    words = symbols[:, :nsteps] if packed == "bt" else symbols[:nsteps].T
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=symbols.device)
    s = (words.to(torch.int32)[..., None] >> shifts) & 255
    return s.reshape(words.shape[0], C.RATE * nsteps)


def _init_metrics(initial_metrics, B: int, device) -> torch.Tensor:
    if initial_metrics is None:
        return acs_ops.init_metrics(B, device)
    init = initial_metrics.to(device=device, dtype=torch.int32).contiguous()
    if init.shape != (B, C.NUM_STATES):
        raise ValueError(f"initial_metrics must be [{B}, 64], "
                         f"got {list(init.shape)}")
    return init


def forward_regs_plain(symbols: torch.Tensor, nsteps: int,
                       initial_metrics: torch.Tensor | None = None,
                       ckpt: int | None = None, packed: bool | str = False,
                       front_pad: int = 0):
    """Plain version of kernel A, batch-vectorized over [B, 64].

    Same arguments and results as ``forward_regs``. Registers shift by
    one input bit per step (the TPU kernels deferred a shift by 6 per
    six-step window; the values at every checkpoint are the same).
    """
    total, ckpt, K, reset_at = _layout(nsteps, ckpt, front_pad)
    B = _batch(symbols, nsteps, packed)
    dev = symbols.device
    if packed == "bt":
        words = symbols[:, :nsteps].T
    elif packed:
        words = symbols[:nsteps]
    else:
        words = pack_symbols(symbols, nsteps)
    words = words.to(torch.int32)
    init = _init_metrics(initial_metrics, B, dev)
    state_idx = torch.arange(C.NUM_STATES, dtype=torch.int32, device=dev)
    odd = state_idx & 1
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=dev)
    metrics, regs = init, state_idx.expand(B, -1)
    out = torch.empty((K, C.NUM_STATES, B), dtype=torch.int32, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    for t in range(total):
        if t == reset_at:
            metrics, regs = init, state_idx.expand(B, -1)
        w = zero if t < front_pad else words[t - front_pad]
        s4 = (w[:, None] >> shifts) & 255                        # [B, 4]
        metrics, dec = acs_ops.acs_step(metrics, acs_ops.branch_metrics(s4))
        # new state 2b+u comes from b (dec 0) or b+32 (dec 1), input u
        lo = regs[:, :32].repeat_interleave(2, dim=1)
        hi = regs[:, 32:].repeat_interleave(2, dim=1)
        regs = (torch.where(dec, hi, lo) << 1) | odd
        if t % 2 == 1:
            metrics = acs_ops.renormalize(metrics)
        if (t + 1) % ckpt == 0 or t + 1 == total:
            out[-(-(t + 1) // ckpt) - 1] = regs.T
    return out, metrics


def forward_regs(symbols: torch.Tensor, nsteps: int,
                 initial_metrics: torch.Tensor | None = None,
                 ckpt: int | None = None, packed: bool | str = False,
                 front_pad: int = 0):
    """Fused forward pass with path-register checkpoints.

    ``symbols``: [B, >=4*nsteps] int32 soft symbols — or one packed word
    per step (``pack_symbols``/``pack_symbols_host``): time-major
    [>=nsteps, B] with ``packed=True``/``"tb"``, or frame-major
    [B, >=nsteps] with ``packed="bt"`` (the host-natural layout, read in
    place).

    ``front_pad`` prepends dead steps of zero symbols; metrics and
    registers restart at the boundary, so the real region is
    bit-identical to an unpadded run (the TPU package's layout contract).

    Returns (ckpt_regs int32[ceil((nsteps+front_pad)/ckpt), 64, B],
    final_metrics int32[B, 64]). Checkpoint k holds, per state, the last
    32 survivor input bits as of step min((k+1)*ckpt, nsteps+front_pad).

    Kernel A on a CUDA tensor, ``forward_regs_plain`` on a CPU tensor;
    ``forward_regs.launches`` counts the kernel's launches.
    """
    if symbols.device.type == "cpu":
        return forward_regs_plain(symbols, nsteps, initial_metrics, ckpt,
                                  packed, front_pad)
    if symbols.device.type != "cuda":
        raise ValueError(f"forward_regs: unsupported device {symbols.device}")
    total, ckpt, K, reset_at = _layout(nsteps, ckpt, front_pad)
    B = _batch(symbols, nsteps, packed)
    dev = symbols.device
    sym, sb, st, unpacked = _strided(symbols, packed)
    init = _init_metrics(initial_metrics, B, dev)
    regs = torch.empty((K, C.NUM_STATES, B), dtype=torch.int32, device=dev)
    metrics = torch.empty((B, C.NUM_STATES), dtype=torch.int32, device=dev)
    if B == 0:
        return regs, metrics
    lib = _build.load()
    err = lib.acs_regs_launch(
        sym.data_ptr(), sb, st, unpacked, init.data_ptr(), B, total,
        front_pad, reset_at, ckpt, regs.data_ptr(), metrics.data_ptr(),
        ACS_THREADS, dev.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "acs_regs")
    forward_regs.launches += 1
    return regs, metrics


forward_regs.launches = 0


def forward_plain(symbols: torch.Tensor, nsteps: int,
                  initial_metrics: torch.Tensor | None = None,
                  packed: bool | str = False):
    """Plain version of kernel C: ``ops.acs.forward`` on the unpacked
    symbols. Same arguments and results as ``forward``."""
    _check_nsteps(nsteps)
    B = _batch(symbols, nsteps, packed)
    init = _init_metrics(initial_metrics, B, symbols.device)
    return acs_ops.forward(unpack_symbols(symbols, nsteps, packed), nsteps,
                           init)


def forward(symbols: torch.Tensor, nsteps: int,
            initial_metrics: torch.Tensor | None = None,
            packed: bool | str = False):
    """The decisions forward pass, twin of ``acs_pallas.forward``.

    ``symbols`` in any ``forward_regs`` layout: unpacked [B, >=4*nsteps],
    time-major packed [>=nsteps, B] (``packed=True``) or frame-major
    packed [B, >=nsteps] (``packed="bt"``). ``nsteps`` is even (the
    renormalization cadence). Returns (decisions int32[nsteps, B, 2],
    final_metrics int32[B, 64]): bit s of word s//32 is the decision into
    state s, as int32 bit patterns.

    Kernel C on a CUDA tensor, ``forward_plain`` on a CPU tensor;
    ``forward.launches`` counts the kernel's launches.
    """
    if symbols.device.type == "cpu":
        return forward_plain(symbols, nsteps, initial_metrics, packed)
    if symbols.device.type != "cuda":
        raise ValueError(f"forward: unsupported device {symbols.device}")
    _check_nsteps(nsteps)
    B = _batch(symbols, nsteps, packed)
    dev = symbols.device
    sym, sb, st, unpacked = _strided(symbols, packed)
    init = _init_metrics(initial_metrics, B, dev)
    dec = torch.empty((nsteps, B, 2), dtype=torch.int32, device=dev)
    metrics = torch.empty((B, C.NUM_STATES), dtype=torch.int32, device=dev)
    if B == 0:
        return dec, metrics
    lib = _build.load()
    err = lib.acs_words_launch(
        sym.data_ptr(), sb, st, unpacked, init.data_ptr(), B, nsteps,
        dec.data_ptr(), metrics.data_ptr(), WORDS_THREADS, dev.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "acs_words")
    forward.launches += 1
    return dec, metrics


forward.launches = 0


def decode(symbols: torch.Tensor, framebits: int,
           packed: bool | str = False) -> torch.Tensor:
    """Fused end-to-end decode: ``forward_regs`` + checkpoint walk.

    ``symbols`` in any ``forward_regs`` layout; ``framebits`` a multiple
    of 8. Returns uint8[B, framebits // 8] MSB-first packed bytes on the
    symbols' device.
    """
    if framebits <= 0 or framebits % 8:
        raise ValueError(f"decode needs framebits % 8 == 0, got {framebits}")
    nsteps = framebits + C.TAIL_BITS
    regs, _ = forward_regs(symbols, nsteps, ckpt=DECODE_CKPT, packed=packed)
    return tb.chainback_regs_cuda(regs, framebits, ckpt=DECODE_CKPT)
