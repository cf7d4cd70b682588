"""Traceback (chainback): the decision-word walks and the checkpoint walk.

The port of ``viterbi_tpu.ops.traceback``:

  * ``chainback_scan`` — the reference's serial walk (chainback.inc:18-41,
    deconvolve.cpp:416-435) over decision words: from state 0 at the end
    of the terminated trellis, read the current state's decision bit and
    hop to the predecessor ``(state >> 1) | (bit << 5)``.
  * ``chainback_words_cuda`` — the same walk emitting 24-bit windows:
    ``tb_words`` runs it as kernel D (``csrc/tb_words.cu``) on a CUDA
    tensor and as its plain version ``tb_words_plain`` on a CPU tensor.
  * ``chainback_blocked`` — the block-parallel traceback in plain torch:
    compose each block's predecessor maps, walk the block boundaries
    serially, then re-walk every block in parallel.
  * ``chainback_regs`` / ``chainback_regs_cuda`` — the walk over
    survivor-register checkpoints (``ops.acs_cuda.forward_regs``): one
    step per checkpoint instead of one per bit. ``tb_walk`` runs it as
    kernel B (``csrc/tb_walk.cu``) on a CUDA tensor and as its plain
    version ``tb_walk_plain`` on a CPU tensor; ``tb_walk_bytes`` has the
    kernel assemble the decoded bytes in the same launch. Kernel B walks
    a frame in several segments at once (``segment_layout``).
  * ``chainback_regs_cuda_anchored`` — the same walk with the anchor
    injected at a per-frame interior checkpoint: block-overlap streaming.

Decision words are int32[T, B, 2] bit patterns: bit s of word s//32 is
the decision into state s (viterbi.h:89-92).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from . import _build

TB_MAX_SEGMENTS = 32   # lanes a frame of kernel B: kMaxSegments of tb_walk.cu
#: Lanes a frame of kernel B by batch on an H100, set from the batch sweep
#: (``probes/kbatch.py``, PERF.md): (frames from which the entry holds,
#: segments), largest batch first. More segments shorten a frame's chain of
#: dependent loads; every segment but the first costs a second walk of a
#: step or two, and from about 49152 frames the serial walk alone keeps the
#: card at its rate of random 32-byte reads (about 40 G loads/s). The
#: thresholds were set at framebits 3072 (K = 129 checkpoints); the
#: crossover also moves with K. Device times there, ms: 1 frame 0.0028
#: (32 segments) against 0.0219 (serial); 4096 frames 0.0157 (16) against
#: 0.0747; 16384 frames 0.0531 (4) against 0.0934; 65536 frames 0.2382 (4)
#: against 0.2207 (serial).
TB_SEGMENTS_BY_BATCH = ((49152, 1), (8192, 4), (2048, 16), (0, 32))
WORDS_TB_THREADS = 128   # frames per block of kernel D
WORDS_WINDOW = 24  # decoded bits per window of kernel D

_PACK_WEIGHTS = 1 << np.arange(7, -1, -1, dtype=np.int32)   # MSB first


def packbits_msb(bits: torch.Tensor) -> torch.Tensor:
    """[..., nbits] {0,1} ints -> [..., ceil(nbits/8)] uint8, MSB-first.

    A partial final byte is MSB-aligned over zero low bits: the reference
    chainback's last-byte contract for framebits % 8 != 0, and
    ``np.packbits`` semantics.
    """
    nbits = bits.shape[-1]
    if nbits % 8:
        bits = torch.nn.functional.pad(bits, (0, 8 - nbits % 8))
    b = bits.reshape(*bits.shape[:-1], -1, 8).to(torch.int32)
    w = torch.as_tensor(_PACK_WEIGHTS, device=bits.device)
    return (b * w).sum(-1).to(torch.uint8)


def decision_bit(words: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The decision into ``state`` at one step: int32[B, 2] decision words
    and int64[B] states -> int64[B] bits (bit s % 32 of word s // 32)."""
    word = words.gather(1, (state >> 5)[:, None])[:, 0]
    # an arithmetic shift of the int32 word, masked to one bit
    return (word.to(torch.int64) >> (state & 31)) & 1


def best_state(metrics: torch.Tensor) -> torch.Tensor:
    """int32[B] index of each frame's lowest metric, the lowest index on
    ties (``torch.argmin`` returns the first minimum on every device): the
    anchor of a walk that does not end in state 0."""
    return torch.argmin(metrics, dim=1).to(torch.int32)


def _walk_bits(decisions: torch.Tensor, framebits: int) -> torch.Tensor:
    """The serial decision walk from state 0: int32[>= framebits+6, B, 2]
    decision words -> int32[framebits, B] decoded bits."""
    B = decisions.shape[1]
    state = torch.zeros(B, dtype=torch.int64, device=decisions.device)
    bits = torch.empty((framebits, B), dtype=torch.int32,
                       device=decisions.device)
    # steps 0..5 are never read: their bits predate the frame
    for t in range(framebits - 1, -1, -1):
        k = decision_bit(decisions[t + C.TAIL_BITS], state)
        bits[t] = k
        state = (state >> 1) | (k << 5)
    return bits


def chainback_scan(decisions: torch.Tensor, framebits: int) -> torch.Tensor:
    """Serial-walk traceback. decisions: int32[>= framebits+6, B, 2].

    Returns uint8[B, ceil(framebits/8)] MSB-first packed data bits.
    """
    return packbits_msb(_walk_bits(decisions, framebits).T)


def _check_words(decisions: torch.Tensor, framebits: int) -> None:
    if framebits <= 0 or framebits % WORDS_WINDOW:
        raise ValueError(f"the word walk needs framebits % 24 == 0, got "
                         f"{framebits}")
    if decisions.dtype != torch.int32 or decisions.dim() != 3 \
            or decisions.shape[2] != 2 \
            or decisions.shape[0] < framebits + C.TAIL_BITS:
        raise ValueError(f"decisions must be int32[>= {framebits + 6}, B, "
                         f"2], got {decisions.dtype}"
                         f"{list(decisions.shape)}")


def tb_words_plain(decisions: torch.Tensor, framebits: int) -> torch.Tensor:
    """Plain version of kernel D: the serial walk over decision words
    int32[>= framebits+6, B, 2] from state 0, newest step first. Returns
    rs int32[framebits/24, B]: data bit t at bit 23 - t%24 of window
    t//24 (the lowest t at the most significant bit)."""
    _check_words(decisions, framebits)
    bits = _walk_bits(decisions, framebits)
    w = WORDS_WINDOW
    shifts = torch.arange(w - 1, -1, -1, dtype=torch.int32,
                          device=decisions.device)
    return (bits.reshape(framebits // w, w, -1) << shifts[:, None]) \
        .sum(1, dtype=torch.int32)


def tb_words(decisions: torch.Tensor, framebits: int) -> torch.Tensor:
    """The decision-word walk: kernel D on a CUDA tensor,
    ``tb_words_plain`` on a CPU tensor. Same arguments and result as
    ``tb_words_plain``."""
    if decisions.device.type == "cpu":
        return tb_words_plain(decisions, framebits)
    if decisions.device.type != "cuda":
        raise ValueError(f"tb_words: unsupported device {decisions.device}")
    _check_words(decisions, framebits)
    decisions = decisions.contiguous()
    B = decisions.shape[1]
    rs = torch.empty((framebits // WORDS_WINDOW, B), dtype=torch.int32,
                     device=decisions.device)
    if B == 0:
        return rs
    _build.TB_WORDS.launch(
        decisions.device, decisions.data_ptr(), B, framebits, rs.data_ptr(),
        WORDS_TB_THREADS)
    return rs


def chainback_words_cuda(decisions: torch.Tensor,
                         framebits: int) -> torch.Tensor:
    """Traceback over decision words through ``tb_words`` (kernel D on
    the card), then byte assembly: the twin of
    ``chainback_words_pallas``. Needs framebits % 24 == 0. Returns
    uint8[B, framebits // 8], bit-exact vs ``chainback_scan``."""
    rs = tb_words(decisions, framebits)
    return _regs_bytes(rs, framebits, WORDS_WINDOW, gap=WORDS_WINDOW,
                       tail=0)


def block_for(framebits: int, block: int = 64) -> int:
    """The blocked traceback's block: ``block`` (the config key
    ``traceback_block``) where it divides framebits, else the largest
    of 64, 48, 32, 24, 16, 8, 4, 2, 1 that does."""
    if framebits % block == 0:
        return block
    return next(b for b in (64, 48, 32, 24, 16, 8, 4, 2, 1)
                if framebits % b == 0)


def chainback_blocked(decisions: torch.Tensor, framebits: int,
                      block: int = 64) -> torch.Tensor:
    """Block-parallel traceback, plain torch; bit-exact vs
    ``chainback_scan``. decisions: int32[>= framebits+6, B, 2];
    ``framebits`` must be a multiple of ``block``. Returns
    uint8[B, framebits // 8].

    Phase 1 composes, for every block in parallel, the predecessor maps
    of its steps into one map from the state at the block's end to the
    state at its start. Phase 2 walks those maps serially from end state
    0 to find every block's end state. Phase 3 re-walks all blocks in
    parallel from their end states.
    """
    if block <= 0 or framebits % block:
        raise ValueError(f"framebits {framebits} is not a multiple of "
                         f"block {block}")
    nblocks = framebits // block
    B = decisions.shape[1]
    dev = decisions.device
    words = decisions[C.TAIL_BITS:C.TAIL_BITS + framebits] \
        .reshape(nblocks, block, B, 2)

    def bits_at(t, state):
        """Decision bits of in-block step t for states [nblocks, B, S]."""
        w = words[:, t].gather(-1, state >> 5)
        return (w.to(torch.int64) >> (state & 31)) & 1

    # phase 1: comp[n, b, s] = state at block n's start given state s at
    # its end; step t's map sends s to (s >> 1) | (bit << 5)
    every = torch.arange(C.NUM_STATES, device=dev).expand(nblocks, B, -1)
    comp = every
    for t in range(block):
        comp = comp.gather(-1, (every >> 1) | (bits_at(t, every) << 5))
    # phase 2: the state at every block's end, from end state 0
    ends = torch.empty((nblocks, B), dtype=torch.int64, device=dev)
    state = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    for n in range(nblocks - 1, -1, -1):
        ends[n] = state[:, 0]
        state = comp[n].gather(-1, state)
    # phase 3: every block's bits from its end state
    state = ends[..., None]
    bits = torch.empty((nblocks, block, B), dtype=torch.int64, device=dev)
    for t in range(block - 1, -1, -1):
        k = bits_at(t, state)
        bits[:, t] = k[..., 0]
        state = (state >> 1) | (k << 5)
    return packbits_msb(bits.permute(2, 0, 1).reshape(B, framebits))


def tb_walk_plain(regs: torch.Tensor, ckpt: int, gap: int,
                  anchor: torch.Tensor | None = None,
                  anchor_k: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel B: the checkpoint walk, newest first.

    ``regs``: int32[K, 64, B] checkpoints; ``anchor``: int32[B] start
    states (None = 0, the terminated trellis); ``anchor_k``: int32[B]
    checkpoint index where the anchor is injected (None = K-1, the
    whole-frame walk; rows above an interior index hold values the
    caller's emit window never reads). Returns rs int32[K, B]: the
    register of the survivor state at each checkpoint. The shift to the
    next state is ``gap`` at checkpoint K-1 and ``ckpt`` elsewhere.
    """
    K, _, B = regs.shape
    dev = regs.device
    a = (torch.zeros(B, dtype=torch.int64, device=dev) if anchor is None
         else anchor.to(device=dev, dtype=torch.int64))
    ak = (torch.full((B,), K - 1, dtype=torch.int64, device=dev)
          if anchor_k is None
          else anchor_k.to(device=dev, dtype=torch.int64))
    state = a
    rs = torch.empty((K, B), dtype=torch.int32, device=dev)
    for k in range(K - 1, -1, -1):
        state = torch.where(ak == k, a, state)
        r = regs[k].gather(0, state[None, :])[0]
        rs[k] = r
        shift = gap if k == K - 1 else ckpt
        state = ((r >> shift) & 63).to(torch.int64)
    return rs


def segment_layout(K: int, segments: int) -> tuple[int, int]:
    """(S, L): the lanes a frame that kernel B really uses for ``K``
    checkpoints when asked for ``segments``, and the checkpoints a lane.
    L = ceil(K / segments), and S = ceil(K / L) <= segments leaves no lane
    without a checkpoint. Lane s walks checkpoints K-1 - s*L down to
    max(K - (s+1)*L, 0)."""
    if not 1 <= segments <= TB_MAX_SEGMENTS:
        raise ValueError(f"segments must lie in [1, {TB_MAX_SEGMENTS}], "
                         f"got {segments}")
    L = -(-K // min(segments, K))
    return -(-K // L), L


def walk_segments(B: int, segments: int | None = None) -> int:
    """Lanes a frame for a batch of ``B``: the caller's, or the entry of
    ``TB_SEGMENTS_BY_BATCH``."""
    if segments is not None:
        return segments
    return next(s for frames, s in TB_SEGMENTS_BY_BATCH if B >= frames)


def _launch_walk(regs, ckpt, gap, anchor, anchor_k, segments,
                 nbytes=None, offset=0, nsteps=0):
    """Kernel B on CUDA checkpoints: (rs int32[K, B], bytes uint8[B,
    nbytes] or None where ``nbytes`` is)."""
    if regs.dtype != torch.int32 or regs.dim() != 3 \
            or regs.shape[1] != C.NUM_STATES:
        raise ValueError(f"tb_walk: regs must be int32[K, 64, B], got "
                         f"{regs.dtype}{list(regs.shape)}")
    if not 1 <= gap <= 26 or not 1 <= ckpt <= 26:
        raise ValueError(f"tb_walk: shifts must lie in [1, 26], got "
                         f"ckpt={ckpt} gap={gap}")
    regs = regs.contiguous()
    K, _, B = regs.shape
    rs = torch.empty((K, B), dtype=torch.int32, device=regs.device)
    out = None if nbytes is None else torch.empty(
        (B, nbytes), dtype=torch.uint8, device=regs.device)
    if K == 0 or B == 0:
        return rs, out
    S, _ = segment_layout(K, walk_segments(B, segments))

    def per_frame(x, lo, hi, what):
        if x is None:
            return None
        # a range check on the card would make the host wait for it, so it
        # is made where the caller's tensor lies on the host; the kernel
        # masks a state to six bits and never reads outside regs
        if x.device.type == "cpu" and x.numel() \
                and bool(((x < lo) | (x >= hi)).any()):
            raise ValueError(f"tb_walk: {what} must lie in [{lo}, {hi})")
        x = x.to(device=regs.device, dtype=torch.int32).contiguous()
        if x.shape != (B,):
            raise ValueError(f"tb_walk: anchors must be [{B}], "
                             f"got {list(x.shape)}")
        return x

    anc = per_frame(anchor, 0, C.NUM_STATES, "anchor states")
    anck = per_frame(anchor_k, 0, K, "anchor checkpoints")
    _build.TB_WALK.launch(
        regs.device, regs.data_ptr(),
        None if anc is None else anc.data_ptr(),
        None if anck is None else anck.data_ptr(), B, K, ckpt, gap,
        rs.data_ptr(), out.data_ptr() if nbytes else None, nbytes or 0,
        offset, nsteps, S)
    return rs, out


def tb_walk(regs: torch.Tensor, ckpt: int, gap: int,
            anchor: torch.Tensor | None = None,
            anchor_k: torch.Tensor | None = None,
            segments: int | None = None) -> torch.Tensor:
    """The checkpoint walk: kernel B on a CUDA tensor, ``tb_walk_plain``
    on a CPU tensor. Same arguments and result as ``tb_walk_plain``.
    ``segments`` names the kernel's form, 1 (the serial walk) to
    ``TB_MAX_SEGMENTS`` lanes a frame; left out, the batch decides
    (``TB_SEGMENTS_BY_BATCH``). The result is the same in every form."""
    if regs.device.type == "cpu":
        return tb_walk_plain(regs, ckpt, gap, anchor, anchor_k)
    if regs.device.type != "cuda":
        raise ValueError(f"tb_walk: unsupported device {regs.device}")
    return _launch_walk(regs, ckpt, gap, anchor, anchor_k, segments)[0]


def tb_walk_bytes(regs: torch.Tensor, framebits: int, ckpt: int, gap: int,
                  tail: int = C.TAIL_BITS, offset: int = 0,
                  anchor: torch.Tensor | None = None,
                  anchor_k: torch.Tensor | None = None,
                  segments: int | None = None):
    """The checkpoint walk with the byte assembly: (rs, bytes) =
    (``tb_walk(...)``, ``_regs_bytes(rs, framebits, ckpt, gap, tail,
    offset)``), for ``ckpt`` <= 24. On a CUDA tensor one launch of kernel
    B (counted as ``tb_walk``) writes both; on a CPU tensor the
    two plain versions run."""
    if regs.device.type == "cpu":
        rs = tb_walk_plain(regs, ckpt, gap, anchor, anchor_k)
        return rs, _regs_bytes(rs, framebits, ckpt, gap, tail, offset)
    if regs.device.type != "cuda":
        raise ValueError(f"tb_walk: unsupported device {regs.device}")
    nsteps = offset + framebits + tail
    _byte_plan(framebits, ckpt, regs.shape[0], nsteps, offset)   # checks
    return _launch_walk(regs, ckpt, gap, anchor, anchor_k, segments,
                        framebits // 8, offset, nsteps)


def _regs_bits(rs: torch.Tensor, framebits: int, ckpt: int,
               gap: int) -> torch.Tensor:
    """Assemble decoded bytes from survivor-register windows bit by bit.

    ``rs``: int32[K, B] — rs[k] holds the ``ckpt`` (``gap`` for k = K-1)
    input bits ending at checkpoint k's trellis time.
    """
    K, B = rs.shape
    dev = rs.device
    shifts = torch.arange(ckpt - 1, -1, -1, dtype=torch.int32, device=dev)
    bits = (rs[: K - 1, None, :] >> shifts[None, :, None]) & 1
    bits = bits.reshape((K - 1) * ckpt, B)
    fshifts = torch.arange(gap - 1, -1, -1, dtype=torch.int32, device=dev)
    fbits = (rs[K - 1][None, :] >> fshifts[:, None]) & 1
    allbits = torch.cat([bits, fbits], dim=0)               # [nsteps, B]
    return packbits_msb(allbits[:framebits].T)


@functools.lru_cache(maxsize=64)
def _byte_plan(framebits: int, ckpt: int, K: int, nsteps: int, offset: int):
    """(k, p): output byte i is (rs[k[i]] >> p[i]) & 255; fixed by the
    shape, so computed once a shape."""
    if ckpt > 24:
        raise ValueError(f"bytes come out of one register only for ckpt "
                         f"<= 24, got {ckpt}")
    i = np.arange(framebits // 8)
    tend = offset + 8 * i + 7              # time of the byte's last bit
    k = np.minimum(tend // ckpt, K - 1)
    wend = np.where(k < K - 1, (k + 1) * ckpt - 1, nsteps - 1)
    p = wend - tend                        # shift within register k
    if not ((p >= 0).all() and (p + 7 <= 31).all()):
        raise ValueError(f"a byte of framebits {framebits} (offset "
                         f"{offset}, {nsteps} steps) lies outside its "
                         f"register at ckpt {ckpt}, K {K}")
    return k, p.astype(np.int32)


def _regs_bytes(rs: torch.Tensor, framebits: int, ckpt: int, gap: int,
                tail: int = C.TAIL_BITS, offset: int = 0) -> torch.Tensor:
    """Byte-granular assembly from survivor-register windows.

    Each checkpoint register holds the last 32 survivor input bits: its
    window plus >= 8 bits of the previous ones, so with ckpt <= 24 every
    output byte lies inside one register: byte i = (rs[k_i] >> p_i) & 255
    with (k_i, p_i) fixed by the shape. ``offset`` skips a front-padded
    region: data bit t of the frame lives at trellis step offset + t.
    """
    K, B = rs.shape
    k, p = _byte_plan(framebits, ckpt, K, offset + framebits + tail, offset)
    r = rs.index_select(0, torch.as_tensor(k, device=rs.device))
    shifts = torch.as_tensor(p, device=rs.device)
    return ((r >> shifts[:, None]) & 255).T.to(torch.uint8)


def chainback_regs(regs: torch.Tensor, framebits: int,
                   ckpt: int = 24) -> torch.Tensor:
    """Traceback over register-exchange checkpoints, plain torch.

    ``regs``: int32[K, 64, B], K = ceil((framebits+6)/ckpt); checkpoint k
    holds, per state, the last 32 survivor input bits as of time
    min((k+1)*ckpt, framebits+6). Returns uint8[B, ceil(framebits/8)].
    """
    nsteps = framebits + C.TAIL_BITS
    K = regs.shape[0]
    assert K == -(-nsteps // ckpt)
    gap = nsteps - (K - 1) * ckpt          # steps covered by checkpoint K-1
    return _regs_bits(tb_walk_plain(regs, ckpt, gap), framebits, ckpt, gap)


def chainback_regs_cuda(regs: torch.Tensor, framebits: int, ckpt: int = 24,
                        tail: int = C.TAIL_BITS,
                        anchor: torch.Tensor | None = None,
                        anchor_k: torch.Tensor | None = None,
                        wrap_last6: bool = False,
                        offset: int = 0) -> torch.Tensor:
    """The checkpoint walk and the byte assembly through
    ``tb_walk_bytes`` (one launch of kernel B on the card; above ckpt 24,
    or where a partial last byte is due, ``tb_walk``, then the bits in
    plain torch). Bit-exact vs ``chainback_regs``: uint8[B,
    ceil(framebits/8)].

    ``tail``/``anchor`` generalize to tail-biting: ``tail=0`` decodes a
    trellis of exactly ``framebits`` steps anchored at ``anchor``
    (int32[B] best end states) instead of the terminated state 0.
    ``anchor_k`` injects the anchor at an interior checkpoint (streaming).
    ``offset`` skips a front-padded region.

    ``wrap_last6`` applies the tail-biting circular convention for the
    final 6 data bits: golden emits data bit t >= framebits-6 from the
    decision at wrapped step t+6-framebits, which equals bit
    (framebits-1-t) of the survivor path's start state — not the anchor
    register's low bits (the two differ when the best path is not
    circularly consistent, e.g. on end-metric ties).
    """
    nsteps = offset + framebits + tail
    K = regs.shape[0]
    assert K == -(-nsteps // ckpt)
    gap = nsteps - (K - 1) * ckpt
    if ckpt <= 24 and framebits % 8 == 0:
        rs, out = tb_walk_bytes(regs, framebits, ckpt, gap, tail, offset,
                                anchor, anchor_k)
    else:
        assert offset == 0
        rs = tb_walk(regs, ckpt, gap, anchor, anchor_k)
        out = _regs_bits(rs, framebits, ckpt, gap)
    if wrap_last6:
        assert tail == 0 and framebits % 8 == 0
        # the survivor path's start state: checkpoint 0's register
        # shifted past its own window
        shift0 = ckpt if K > 1 else gap
        state0 = (rs[0] >> shift0) & 63
        last = (out[:, -1].to(torch.int32) & 0xC0) | state0
        out[:, -1] = last.to(torch.uint8)
    return out


def chainback_regs_cuda_anchored(regs: torch.Tensor, anchor_k: torch.Tensor,
                                 anchor_state: torch.Tensor, emit_bits: int,
                                 ckpt: int) -> torch.Tensor:
    """The anchored checkpoint walk of block-overlap streaming, the twin
    of ``chainback_regs_pallas_anchored``: one launch of kernel B on the
    card (``tb_walk_bytes``), ``tb_walk_plain`` + ``_regs_bytes`` on the
    CPU.

    ``regs``: int32[K, 64, B] checkpoints of a trellis of exactly K*ckpt
    steps; ``anchor_k``: int32[B] checkpoint at which ``anchor_state``
    (int32[B]) is injected; checkpoints above it hold values the emit
    window never reads. Returns the first ``emit_bits`` (a multiple of 8)
    decoded bits as uint8[B, emit_bits // 8]. The tail runs to the end
    of the trellis, so the last emitted byte reads its own window.
    """
    if ckpt > 24 or emit_bits % 8:
        raise ValueError(f"the anchored walk needs ckpt <= 24 and whole "
                         f"bytes, got ckpt {ckpt}, {emit_bits} bits")
    K = regs.shape[0]
    _, out = tb_walk_bytes(regs, emit_bits, ckpt, gap=ckpt,
                           tail=K * ckpt - emit_bits, anchor=anchor_state,
                           anchor_k=anchor_k)
    return out
