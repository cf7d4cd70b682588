"""Block-overlap streaming Viterbi: the port of
``viterbi_tpu.parallel.streaming``.

One long terminated stream is cut into time blocks, and every block is
decoded at once instead of one serial trellis over the whole stream. Each
block:

  1. runs a short warm-up ACS over the end of its own block from uniform
     metrics (the decoder forgets its initial condition in about 5K
     steps, so the boundary metrics come out effectively exact); the
     first block of a stream starts from the terminated start instead;
  2. takes its left neighbour's boundary metrics as entry metrics;
  3. re-runs ACS over its block plus an overlap of its right neighbour's
     first steps (the last block: the six tail steps, then zeros);
  4. walks back from the overlap's end (the best state; the last block
     from state 0 at the true termination) and keeps its own block's bits
     only: the overlap absorbs the anchor's uncertainty.

Two forms of the same mechanism. ``make_local_stream_decoder`` folds the
blocks into the batch of one device (row ``b * n_blocks + d`` holds block
d of stream b): the exchanges are rolls along the block axis.
``make_stream_decoder`` puts block d on seq rank d of a mesh
(``parallel.mesh``): the boundary metrics go to the right neighbour and
the overlap prefix to the left one as point-to-point sends, the
``ppermute``s of the JAX ring, two a call whatever the stream's length.
Both hand their rows to one core, ``_decode_blocks``, with the two
exchanges as functions.

No reference analog: the DLL decodes long streams 9216-bit frame by frame
with a metric reset at every boundary (deconvolve.cpp:97-100).

With the kernels (symbols on a card) the symbols are packed to one word a
step first, so every slice, exchange and concatenation moves a quarter of
the bytes, and the words feed kernel A frame-major (``packed="bt"``) in
place: kernel A runs the warm-up and the full pass, kernel B the anchored
walk with the bytes (``traceback.chainback_regs_cuda_anchored``), three
launches a call (a rank). Without: ``acs.forward`` twice and
``_anchored_chainback``. Both are bit-identical to the JAX package.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..ops import acs, acs_cuda
from ..ops import traceback as tb
from ..runtime.placement import on_device, strict_device, want_kernels
from . import distributed
from . import mesh as mesh_mod

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


def _decode_blocks(x: torch.Tensor, tail: torch.Tensor, right, left,
                   first: slice, last: slice, blk: int, overlap: int,
                   warm: int, ckpt: int | None) -> torch.Tensor:
    """The block-overlap mechanism, one block a row, in both forms.

    ``x``: this call's blocks, one a row: packed words int32[N, blk]
    (``ckpt`` set: kernel A twice and kernel B once, their plain versions
    on a CPU tensor) or symbols int32[N, 4*blk] (``ckpt=None``: the plain
    form, ``acs.forward`` twice and ``_anchored_chainback``). ``tail``:
    the tail columns of the rows ``last`` selects, in ``x``'s layout.
    ``right(t)`` gives each row ``t`` of the row holding the previous
    block, ``left(t)`` that of the next block: the two exchanges, made in
    this order. ``first`` and ``last`` select the rows holding the first
    and the last block of a stream. Returns uint8[N, blk // 8]."""
    r = C.RATE if ckpt is None else 1          # columns a step
    if ckpt is None:
        fwd = acs.forward
    else:
        fwd = lambda s, n, init: acs_cuda.forward_regs(
            s, n, initial_metrics=init, ckpt=ckpt, packed="bt")
    N, dev = x.shape[0], x.device
    init = _uniform_metrics(N, dev)
    init[first, 0] = 0                         # the terminated start
    _, bmet = fwd(x[:, r * (blk - warm):], warm, init)
    # boundary metrics ride right, the overlap prefix rides left
    entry = right(bmet)
    entry[first] = acs.init_metrics(1, dev)
    ext = left(x[:, :r * overlap])
    ext[last] = 0                              # the tail, then zeros
    ext[last, :r * C.TAIL_BITS] = tail
    out, fmet = fwd(torch.cat([x, ext], dim=1), blk + overlap, entry)
    # anchor: the best state at the overlap's end; the last block state 0
    # after the tail, its true termination
    state = tb.best_state(fmet)
    state[last] = 0
    if ckpt is None:
        pos = torch.full_like(state, blk + overlap - 1)
        pos[last] = blk + C.TAIL_BITS - 1
        return _anchored_chainback(out, pos, state, blk + overlap, blk)
    pos = torch.full_like(state, (blk + overlap) // ckpt - 1)
    pos[last] = (blk + C.TAIL_BITS) // ckpt - 1
    return tb.chainback_regs_cuda_anchored(out, pos, state, blk, ckpt)


def _folded(syms: torch.Tensor, tail_syms: torch.Tensor, n_blocks: int,
            blk: int, overlap: int, warm: int, ckpt: int | None):
    """The blocks folded into the batch (row ``b * n_blocks + d`` holds
    block d of stream b): the exchanges are rolls along the block axis."""
    B = syms.shape[0]
    if ckpt is None:
        x = syms[:, :C.RATE * n_blocks * blk].to(torch.int32)
        tail = tail_syms.to(torch.int32)
    else:   # frame-major words [B, T]: the transpose of pack_symbols' view
        x = acs_cuda.pack_symbols(syms, n_blocks * blk).T
        tail = acs_cuda.pack_symbols(tail_syms, C.TAIL_BITS).T
    x = x.reshape(B * n_blocks, -1)

    def roll(by):
        return lambda t: torch.roll(t.reshape(B, n_blocks, -1), by,
                                    dims=1).reshape(B * n_blocks, -1)

    out = _decode_blocks(x, tail, roll(1), roll(-1),
                         slice(None, None, n_blocks),
                         slice(n_blocks - 1, None, n_blocks),
                         blk, overlap, warm, ckpt)
    return out.reshape(B, n_blocks * blk // 8)


def decode_kernels(syms: torch.Tensor, tail_syms: torch.Tensor,
                   n_blocks: int, blk: int, overlap: int, warm: int,
                   ckpt: int) -> torch.Tensor:
    """The kernel form: two launches of kernel A, one of kernel B (their
    plain versions on a CPU tensor). ``syms``: int[B, >= 4*n_blocks*blk],
    ``tail_syms``: int[B, 24]. Returns uint8[B, n_blocks*blk // 8]."""
    return _folded(syms, tail_syms, n_blocks, blk, overlap, warm, ckpt)


def make_local_stream_decoder(stream_bits: int, n_blocks: int,
                              overlap: int | None = None,
                              use_kernels: bool | None = None,
                              warmup: int | None = None, device=None):
    """One-card block-overlap streaming: the ``n_blocks`` time blocks of a
    terminated stream of ``stream_bits`` data bits folded into the batch.

    ``overlap=None`` takes ``DEFAULT_OVERLAP``, clamped or aligned to fit
    small blocks; an explicit overlap that cannot fit raises. The layout
    is planned here, for the form that ``use_kernels`` gives on
    ``device`` (the card unless the caller names another; a raise without
    one), so a block too small for it raises at once.

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

    plan(want_kernels(use_kernels, strict_device(device)))

    def decode(symbols, tail_syms):
        syms = on_device(symbols, device)
        tail = on_device(tail_syms, syms.device)
        if syms.dim() != 2 or syms.shape[1] < C.RATE * stream_bits \
                or tail.shape != (syms.shape[0], C.RATE * C.TAIL_BITS):
            raise ValueError(
                f"symbols must be [B, {C.RATE * stream_bits}] and tail "
                f"symbols [B, {C.RATE * C.TAIL_BITS}], got "
                f"{list(syms.shape)} and {list(tail.shape)}")
        return _folded(syms, tail, n_blocks, blk,
                       *plan(want_kernels(use_kernels, syms.device)))

    return decode


def _ring(syms: torch.Tensor, tail_syms: torch.Tensor, group, s: int,
          n_seq: int, blk: int, overlap: int, warm: int,
          ckpt: int | None) -> torch.Tensor:
    """Seq rank ``s``'s block of every frame: the exchanges are sends to
    the ring's neighbours. ``syms``: int[B, 4*blk] this block's symbols,
    ``tail_syms``: int[B, 24]; ``ckpt=None`` the plain form. Returns
    uint8[B, blk // 8]."""
    if ckpt is None:
        x = syms[:, :C.RATE * blk].to(torch.int32)
        tail = tail_syms.to(torch.int32)
    else:
        x = acs_cuda.pack_symbols(syms, blk).T       # frame-major [B, blk]
        tail = acs_cuda.pack_symbols(tail_syms, C.TAIL_BITS).T
    first = slice(None) if s == 0 else slice(0)      # all rows or none
    last = slice(None) if s == n_seq - 1 else slice(0)

    def shift(dst, src, tag):
        def send(t):
            got = mesh_mod.exchange(group, t, dst, src, tag)
            return torch.zeros_like(t) if got is None else got
        return send

    right = shift(s + 1 if s < n_seq - 1 else None,
                  s - 1 if s > 0 else None, 0)
    left = shift(s - 1 if s > 0 else None,
                 s + 1 if s < n_seq - 1 else None, 1)
    return _decode_blocks(x, tail[last], right, left, first, last, blk,
                          overlap, warm, ckpt)


def make_stream_decoder(mesh: mesh_mod.Mesh, stream_bits: int,
                        overlap: int | None = None,
                        use_kernels: bool | None = None,
                        warmup: int | None = None):
    """The ring: terminated streams of ``stream_bits`` data bits, block d
    on seq rank d of ``mesh``, frames over its data axis.

    ``overlap=None`` takes ``DEFAULT_OVERLAP``, clamped or aligned to fit
    small blocks; an explicit overlap that cannot fit raises. The layout
    is planned here for the form ``use_kernels`` gives on the mesh's
    device (``None``: the kernels on a card, the plain form on the CPU),
    so a block too small for it raises at once.

    Returns ``decode(symbols, tail_syms)``: ``symbols`` int[B,
    4*stream_bits] the data-bit symbols, ``tail_syms`` int[B, 24] the
    flush-bit symbols, the whole batch on every rank (tensors or host
    arrays; only this rank's block goes to its device); ``B`` divides over
    the data axis. Every rank gets uint8[B, stream_bits // 8] on its
    device, the same as ``make_local_stream_decoder(stream_bits,
    n_blocks=n_seq)`` gives on one.
    """
    n_seq = mesh.shape[mesh_mod.SEQ_AXIS]
    if stream_bits % n_seq:
        raise ValueError(f"{stream_bits} stream bits do not divide over "
                         f"{n_seq} seq ranks")
    blk = stream_bits // n_seq
    overlap, warm, ckpt = _plan_block_layout(
        blk, overlap, warmup, want_kernels(use_kernels, mesh.device))
    s = mesh.coords[mesh_mod.SEQ_AXIS]
    ring = mesh.groups[mesh_mod.SEQ_AXIS]

    def decode(symbols, tail_syms):
        if symbols.ndim != 2 or symbols.shape[1] < C.RATE * stream_bits \
                or tuple(tail_syms.shape) != (symbols.shape[0],
                                              C.RATE * C.TAIL_BITS):
            raise ValueError(
                f"symbols must be [B, {C.RATE * stream_bits}] and tail "
                f"symbols [B, {C.RATE * C.TAIL_BITS}], got "
                f"{list(symbols.shape)} and {list(tail_syms.shape)}")
        rows = mesh_mod.local_rows(symbols, mesh)
        syms = on_device(rows[:, C.RATE * blk * s: C.RATE * blk * (s + 1)],
                         mesh.device)
        tail = on_device(mesh_mod.local_rows(tail_syms, mesh), mesh.device)
        out = _ring(syms, tail, ring, s, n_seq, blk, overlap, warm, ckpt)
        out = mesh_mod.all_gather_rows(ring, out, dim=1)
        return mesh_mod.all_gather_rows(mesh.groups[mesh_mod.DATA_AXIS], out)

    return decode


def decode_stream(symbols, framebits: int, mesh: mesh_mod.Mesh | None = None,
                  overlap: int | None = None,
                  use_kernels: bool | None = None,
                  warmup: int | None = None) -> torch.Tensor:
    """``symbols`` int[B, 4*(framebits+6)] of terminated streams: split
    the data and tail symbols and decode on the ring. ``mesh=None`` takes
    one ring over the whole job (``distributed.make_node_mesh``). Returns
    uint8[B, framebits // 8] on every rank."""
    if mesh is None:
        mesh = distributed.make_node_mesh(distributed.job()[0])
    data = symbols[:, :C.RATE * framebits]
    tail = symbols[:, C.RATE * framebits: C.RATE * (framebits + C.TAIL_BITS)]
    return make_stream_decoder(mesh, framebits, overlap, use_kernels,
                               warmup)(data, tail)
