"""Block-overlap streaming Viterbi on one card: the port of the one-card
half of ``viterbi_tpu.parallel.streaming``.

One long terminated stream is cut into ``n_blocks`` time blocks, and the
blocks are folded into the batch (row ``b * n_blocks + d`` holds block d
of stream b), so that every block's ACS runs at once instead of one
serial trellis over the whole stream. Each block:

  1. runs a short warm-up ACS over the end of its own block from uniform
     metrics (the decoder forgets its initial condition in about 5K
     steps, so the boundary metrics come out effectively exact); the
     first block of a stream starts from the terminated start instead;
  2. takes its left neighbour's boundary metrics as entry metrics: the
     ring is a roll along the block axis;
  3. re-runs ACS over its block plus an overlap of its right neighbour's
     first steps (the last block: the six tail steps, then zeros);
  4. walks back from the overlap's end (the best state; the last block
     from state 0 at the true termination) and keeps its own block's bits
     only: the overlap absorbs the anchor's uncertainty.

No reference analog: the DLL decodes long streams 9216-bit frame by frame
with a metric reset at every boundary (deconvolve.cpp:97-100).

With the kernels (symbols on a card) the symbols are packed to one word a
step first, so every slice, roll and concatenation moves a quarter of the
bytes, and the folded rows feed kernel A frame-major (``packed="bt"``)
in place: kernel A runs the warm-up and the full pass, kernel B the
anchored walk with the bytes (``traceback.chainback_regs_cuda_anchored``),
three launches a call. Without: ``acs.forward`` twice and
``_anchored_chainback``. Both are bit-identical to the JAX package.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..ops import acs, acs_cuda
from ..ops import traceback as tb
from ..runtime.placement import default_device, on_device, want_kernels

# Overlap is the truncation-reliability knob: the measured sweep
# (OVERLAP_SWEEP.json, scripts/overlap_sweep.py; 3.1 Mbit per cell at
# 3072-bit blocks) shows streaming == whole-stream decode for overlap
# >= 16 at the 3 dB DAB operating point, >= 48 at 1.5 dB, and >= 120 at
# 0 dB. 120 costs 3.9 % redundant compute per 3072-bit block.
DEFAULT_OVERLAP = 120  # steps; must be even and >= TAIL_BITS
WARMUP_STEPS = 128     # pass-1 ACS length for boundary-metric estimation
#   (same sweep, warm-up axis at overlap 120: 64 still leaves 70
#   mismatched bits at 0 dB; 128 and 256 are both exactly clean)


def _uniform_metrics(batch: int, device) -> torch.Tensor:
    return torch.full((batch, C.NUM_STATES), 63, dtype=torch.int32,
                      device=device)


def _anchored_chainback(decisions: torch.Tensor, anchor_j: torch.Tensor,
                        anchor_state: torch.Tensor, tb_steps: int,
                        block_steps: int) -> torch.Tensor:
    """Walk ``decisions`` int32[tb_steps, B, 2] backward from state 0,
    forcing ``state = anchor_state`` on reaching decision index
    ``anchor_j`` (both int[B]); emit the data bits of indices
    [TAIL_BITS, TAIL_BITS + block_steps) as uint8[B,
    ceil(block_steps/8)]."""
    dev = decisions.device
    a = anchor_state.to(device=dev, dtype=torch.int64)
    aj = anchor_j.to(device=dev, dtype=torch.int64)
    state = torch.zeros_like(a)
    bits = torch.empty((tb_steps, decisions.shape[1]), dtype=torch.int64,
                       device=dev)
    for j in range(tb_steps - 1, -1, -1):
        state = torch.where(aj == j, a, state)
        k = tb.decision_bit(decisions[j], state)
        bits[j] = k
        state = (state >> 1) | (k << 5)
    return tb.packbits_msb(bits[C.TAIL_BITS: C.TAIL_BITS + block_steps].T)


def _plan_block_layout(blk: int, overlap, warmup, use_kernels: bool):
    """The per-block layout, shared with the sharded ring: check the
    block's granularity, clamp or round the overlap, pick the checkpoint
    period and the warm-up length.

    Returns ``(overlap, warm, ckpt)`` (ckpt None on the plain path).
    Raises descriptive ValueErrors for blocks too small for the mechanism
    ("use more data bits per device").
    """
    explicit = overlap is not None
    if overlap is None:
        overlap = DEFAULT_OVERLAP
    if blk % 8:
        raise ValueError(
            f"per-device block of {blk} bits is not byte-granular; "
            f"use more data bits per device")
    if not explicit and overlap > blk:
        # small blocks: clamp the *default* overlap so short streams keep
        # working; an explicit overlap that does not fit raises below
        overlap = blk - (blk % 2)
    if overlap % 2 or overlap < C.TAIL_BITS or overlap > blk:
        raise ValueError(
            f"overlap {overlap} does not fit the {blk}-bit per-device "
            f"block; use more data bits per device or a smaller overlap")
    warm = min(WARMUP_STEPS if warmup is None else warmup, blk)
    if not use_kernels:
        return overlap, warm, None
    # anchor times (blk + TAIL_BITS for the final block, blk + overlap
    # elsewhere) must land on checkpoints
    if blk % 6:
        raise ValueError(
            f"kernel streaming needs 6 | block bits (got {blk}); use "
            f"more data bits per device or use_kernels=False")
    ckpt = next(d for d in (24, 18, 12, 6)
                if (blk + C.TAIL_BITS) % d == 0)
    if ckpt > blk:
        raise ValueError(
            f"per-device block of {blk} bits is smaller than its "
            f"checkpoint period {ckpt}; use more data bits per device")
    overlap += (-(overlap - C.TAIL_BITS)) % ckpt   # = TAIL (mod ckpt)
    if overlap > blk:
        if explicit:
            raise ValueError(
                f"overlap {overlap} (after checkpoint rounding) exceeds "
                f"the {blk}-bit per-device block; use more data bits "
                f"per device or a smaller overlap")
        # default overlap: align DOWN instead (the clamp above may have
        # landed between checkpoints)
        overlap -= ckpt * (-(-(overlap - blk) // ckpt))
        if overlap < C.TAIL_BITS:
            raise ValueError(
                f"per-device block of {blk} bits cannot fit any "
                f"checkpoint-aligned overlap (ckpt {ckpt}); use more "
                f"data bits per device")
    warm = max(ckpt, warm - warm % ckpt)
    return overlap, warm, ckpt


def _entry_metrics(bmet: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Block d's entry metrics are block d-1's boundary metrics (a roll
    along the block axis); first blocks enter from the terminated start."""
    N = bmet.shape[0]
    entry = torch.roll(bmet.reshape(N // n_blocks, n_blocks, -1), 1,
                       dims=1).reshape(N, -1)
    entry[::n_blocks] = acs.init_metrics(1, bmet.device)
    return entry


def _warm_init(N: int, n_blocks: int, device) -> torch.Tensor:
    """Warm-up start: uniform metrics, first blocks the terminated start."""
    init = _uniform_metrics(N, device)
    init[::n_blocks, 0] = 0
    return init


def _anchors(best: torch.Tensor, n_blocks: int, at: int, last_at: int):
    """(anchor states, anchor positions) int32[N]: the best state at
    ``at``, the last block of each stream state 0 at ``last_at``."""
    state = best.clone()
    state[n_blocks - 1::n_blocks] = 0
    pos = torch.full_like(state, at)
    pos[n_blocks - 1::n_blocks] = last_at
    return state, pos


def decode_kernels(syms: torch.Tensor, tail_syms: torch.Tensor,
                   n_blocks: int, blk: int, overlap: int, warm: int,
                   ckpt: int) -> torch.Tensor:
    """The kernel form: two launches of kernel A, one of kernel B (their
    plain versions on a CPU tensor). ``syms``: int[B, >= 4*n_blocks*blk],
    ``tail_syms``: int[B, 24]. Returns uint8[B, n_blocks*blk // 8]."""
    B, N = syms.shape[0], syms.shape[0] * n_blocks
    # frame-major words [B, T]: the transpose of pack_symbols' view
    words = acs_cuda.pack_symbols(syms, n_blocks * blk).T
    flat = words.reshape(N, blk)                 # row b*n_blocks + d
    ext = torch.roll(flat[:, :overlap].reshape(B, n_blocks, overlap), -1,
                     dims=1)                     # the right neighbour's prefix
    ext[:, -1, :C.TAIL_BITS] = acs_cuda.pack_symbols(tail_syms,
                                                     C.TAIL_BITS).T
    ext[:, -1, C.TAIL_BITS:] = 0
    full = torch.cat([flat, ext.reshape(N, overlap)], dim=1)
    fwd = lambda s, n, init: acs_cuda.forward_regs(
        s, n, initial_metrics=init, ckpt=ckpt, packed="bt")
    _, bmet = fwd(flat[:, blk - warm:], warm, _warm_init(N, n_blocks,
                                                         syms.device))
    regs, fmet = fwd(full, blk + overlap, _entry_metrics(bmet, n_blocks))
    state, k = _anchors(tb.best_state(fmet), n_blocks,
                        (blk + overlap) // ckpt - 1,
                        (blk + C.TAIL_BITS) // ckpt - 1)
    out = tb.chainback_regs_cuda_anchored(regs, k, state, blk, ckpt)
    return out.reshape(B, n_blocks * blk // 8)


def decode_plain(syms: torch.Tensor, tail_syms: torch.Tensor,
                 n_blocks: int, blk: int, overlap: int,
                 warm: int) -> torch.Tensor:
    """The plain form: ``acs.forward`` twice and ``_anchored_chainback``.
    Same arguments and result as ``decode_kernels``."""
    B, N = syms.shape[0], syms.shape[0] * n_blocks
    flat = syms[:, :C.RATE * n_blocks * blk].to(torch.int32) \
        .reshape(N, C.RATE * blk)
    ext = torch.roll(flat[:, :C.RATE * overlap].reshape(B, n_blocks, -1),
                     -1, dims=1)
    ext[:, -1, :C.RATE * C.TAIL_BITS] = tail_syms.to(torch.int32)
    ext[:, -1, C.RATE * C.TAIL_BITS:] = 0
    full = torch.cat([flat, ext.reshape(N, -1)], dim=1)
    _, bmet = acs.forward(flat[:, C.RATE * (blk - warm):], warm,
                          _warm_init(N, n_blocks, syms.device))
    hist, fmet = acs.forward(full, blk + overlap,
                             _entry_metrics(bmet, n_blocks))
    state, j = _anchors(tb.best_state(fmet), n_blocks,
                        blk + overlap - 1, blk + C.TAIL_BITS - 1)
    out = _anchored_chainback(hist, j, state, blk + overlap, blk)
    return out.reshape(B, n_blocks * blk // 8)


def make_local_stream_decoder(stream_bits: int, n_blocks: int,
                              overlap: int | None = None,
                              use_kernels: bool | None = None,
                              warmup: int | None = None, device=None):
    """One-card block-overlap streaming: the ``n_blocks`` time blocks of a
    terminated stream of ``stream_bits`` data bits folded into the batch.

    ``overlap=None`` takes ``DEFAULT_OVERLAP``, clamped or aligned to fit
    small blocks; an explicit overlap that cannot fit raises. The layout
    is planned here, for the form that ``use_kernels`` gives on
    ``device`` (the card where there is one), so a block too small for it
    raises at once.

    Returns ``decode(symbols, tail_syms)``: ``symbols`` int[B,
    4*stream_bits], ``tail_syms`` int[B, 24] (tensors or host arrays,
    placed as ``runtime.placement`` says) -> uint8[B, stream_bits // 8]
    on the symbols' device. ``use_kernels=None`` takes kernels A and B on
    a CUDA tensor and the plain form on a CPU tensor.
    """
    assert stream_bits % n_blocks == 0
    blk = stream_bits // n_blocks
    plans: dict[bool, tuple] = {}

    def plan(kernels: bool):
        if kernels not in plans:
            plans[kernels] = _plan_block_layout(blk, overlap, warmup, kernels)
        return plans[kernels]

    plan(want_kernels(use_kernels, default_device(device)))

    def decode(symbols, tail_syms):
        syms = on_device(symbols, device)
        tail = on_device(tail_syms, syms.device)
        if syms.dim() != 2 or syms.shape[1] < C.RATE * stream_bits \
                or tail.shape != (syms.shape[0], C.RATE * C.TAIL_BITS):
            raise ValueError(
                f"symbols must be [B, {C.RATE * stream_bits}] and tail "
                f"symbols [B, {C.RATE * C.TAIL_BITS}], got "
                f"{list(syms.shape)} and {list(tail.shape)}")
        if want_kernels(use_kernels, syms.device):
            ovl, warm, ckpt = plan(True)
            return decode_kernels(syms, tail, n_blocks, blk, ovl, warm,
                                  ckpt)
        ovl, warm, _ = plan(False)
        return decode_plain(syms, tail, n_blocks, blk, ovl, warm)

    return decode
