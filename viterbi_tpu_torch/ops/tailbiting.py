"""Tail-biting wrap decode: the port of ``viterbi_tpu.ops.tailbiting``,
bit-exact vs ``golden.tailbiting_decode``.

The DAB mother code is terminated, so the reference has no tail-biting
path (SURVEY.md §2.1); the semantics are the golden model's wrap
heuristic: zero initial metrics, a warm-up ACS over the last
``wrap_steps`` steps, the full recorded pass from there, the best end
state as anchor (lowest metric, lowest index on ties) and a circular
chainback in which step t's decision yields data bit (t - 6) mod
framebits.

With the kernels (symbols on a card): kernel C (``acs_cuda.forward``)
runs the warm-up, as the reference's ``acs.forward`` does there; kernel
A (``acs_cuda.forward_regs``) the recorded pass from the warm-up's
metrics; kernel B (``traceback.chainback_regs_cuda``) the walk anchored
at the best end state with no tail, and ``wrap_last6`` gives the last six
data bits the circular convention. Three launches a call, no loop over
steps on the host. Without: ``acs.forward`` twice and the scan walk from
the anchor, rolled by ``TAIL_BITS``.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..runtime.placement import on_device, want_kernels
from . import acs, acs_cuda
from . import traceback as tb


def _warm_metrics(syms: torch.Tensor, framebits: int, wrap_steps: int,
                  forward) -> torch.Tensor:
    """Metrics after the warm-up over the last ``wrap_steps`` steps from
    zero metrics, through ``forward`` (kernel C's wrapper or
    ``acs.forward``)."""
    zero = torch.zeros((syms.shape[0], C.NUM_STATES), dtype=torch.int32,
                       device=syms.device)
    if wrap_steps == 0:
        return zero
    warm = syms[:, C.RATE * (framebits - wrap_steps):]
    return forward(warm, wrap_steps, zero)[1]


def decode_kernels(syms: torch.Tensor, framebits: int,
                   wrap_steps: int) -> torch.Tensor:
    """The kernel form: kernels C, A and B (their plain versions on a CPU
    tensor). ``syms``: int32[B, >= 4*framebits]; framebits % 8 == 0."""
    if framebits % 8:
        raise ValueError(f"the kernel form needs framebits % 8 == 0, got "
                         f"{framebits}")
    metrics = _warm_metrics(syms, framebits, wrap_steps, acs_cuda.forward)
    ckpt = acs_cuda.choose_ckpt(framebits)
    regs, fmet = acs_cuda.forward_regs(syms, framebits,
                                       initial_metrics=metrics, ckpt=ckpt)
    return tb.chainback_regs_cuda(regs, framebits, ckpt=ckpt, tail=0,
                                  anchor=tb.best_state(fmet), wrap_last6=True)


def decode_plain(syms: torch.Tensor, framebits: int,
                 wrap_steps: int) -> torch.Tensor:
    """The plain form: ``acs.forward`` twice, the serial walk over the
    decision words from the anchor, a roll by ``TAIL_BITS``."""
    metrics = _warm_metrics(syms, framebits, wrap_steps, acs.forward)
    decisions, metrics = acs.forward(syms, framebits, metrics)
    state = tb.best_state(metrics).to(torch.int64)
    bits = torch.empty((framebits, syms.shape[0]), dtype=torch.int64,
                       device=syms.device)
    for t in range(framebits - 1, -1, -1):
        k = tb.decision_bit(decisions[t], state)
        bits[t] = k
        state = (state >> 1) | (k << 5)
    # the decision at step t is data bit (t - 6) mod framebits
    return tb.packbits_msb(torch.roll(bits, -C.TAIL_BITS, dims=0).T)


def decode_tailbiting(symbols, framebits: int, wrap_steps: int = 96,
                      use_kernels: bool | None = None,
                      device=None) -> torch.Tensor:
    """Decode tail-biting frames: int [B, >= 4*framebits] soft symbols (a
    tensor or a host array, placed as ``runtime.placement`` says) ->
    uint8[B, ceil(framebits/8)] MSB-first packed bytes on the symbols'
    device.

    ``use_kernels=None`` takes kernels C, A and B on a CUDA tensor (the
    kernel form needs framebits % 8 == 0) and the plain form on a CPU
    tensor. Both are bit-identical to ``golden.tailbiting_decode``.
    """
    assert wrap_steps % 2 == 0 and wrap_steps <= framebits
    syms = on_device(symbols, device)
    if syms.dim() != 2 or syms.shape[1] < C.RATE * framebits:
        raise ValueError(f"symbols must be [B, >= {C.RATE * framebits}], "
                         f"got {list(syms.shape)}")
    syms = syms[:, : C.RATE * framebits]
    if want_kernels(use_kernels, syms.device):
        return decode_kernels(syms, framebits, wrap_steps)
    return decode_plain(syms, framebits, wrap_steps)
