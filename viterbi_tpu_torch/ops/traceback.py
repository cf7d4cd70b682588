"""Traceback (chainback): the serial decision walk and the checkpoint walk.

The port of the parts of ``viterbi_tpu.ops.traceback`` on the fused
decode path:

  * ``chainback_scan`` — the reference's serial walk (chainback.inc:18-41,
    deconvolve.cpp:416-435) over decision words: from state 0 at the end
    of the terminated trellis, read the current state's decision bit and
    hop to the predecessor ``(state >> 1) | (bit << 5)``.
  * ``chainback_regs`` / ``chainback_regs_cuda`` — the walk over
    survivor-register checkpoints (``ops.acs_cuda.forward_regs``): one
    step per checkpoint instead of one per bit. ``tb_walk`` runs it as
    kernel B (``csrc/tb_walk.cu``) on a CUDA tensor and as its plain
    version ``tb_walk_plain`` on a CPU tensor.

Decision words are int32[T, B, 2] bit patterns: bit s of word s//32 is
the decision into state s (viterbi.h:89-92).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import constants as C
from . import _build

TB_THREADS = 128   # frames per block of kernel B

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


def chainback_scan(decisions: torch.Tensor, framebits: int) -> torch.Tensor:
    """Serial-walk traceback. decisions: int32[>= framebits+6, B, 2].

    Returns uint8[B, ceil(framebits/8)] MSB-first packed data bits.
    """
    B = decisions.shape[1]
    state = torch.zeros(B, dtype=torch.int64, device=decisions.device)
    bits = torch.empty((B, framebits), dtype=torch.int64,
                       device=decisions.device)
    # steps 0..5 are never read: their bits predate the frame
    for t in range(framebits - 1, -1, -1):
        word = decisions[t + C.TAIL_BITS].gather(1, (state >> 5)[:, None])
        k = (word[:, 0].to(torch.int64) >> (state & 31)) & 1
        bits[:, t] = k
        state = (state >> 1) | (k << 5)
    return packbits_msb(bits)


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


def tb_walk(regs: torch.Tensor, ckpt: int, gap: int,
            anchor: torch.Tensor | None = None,
            anchor_k: torch.Tensor | None = None) -> torch.Tensor:
    """The checkpoint walk: kernel B on a CUDA tensor, ``tb_walk_plain``
    on a CPU tensor. Same arguments and result as ``tb_walk_plain``;
    ``tb_walk.launches`` counts the kernel's launches."""
    if regs.device.type == "cpu":
        return tb_walk_plain(regs, ckpt, gap, anchor, anchor_k)
    if regs.device.type != "cuda":
        raise ValueError(f"tb_walk: unsupported device {regs.device}")
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
    if K == 0 or B == 0:
        return rs

    def per_frame(x):
        if x is None:
            return None
        x = x.to(device=regs.device, dtype=torch.int32).contiguous()
        if x.shape != (B,):
            raise ValueError(f"tb_walk: anchors must be [{B}], "
                             f"got {list(x.shape)}")
        return x

    anc, anck = per_frame(anchor), per_frame(anchor_k)
    if anc is not None and bool(((anc < 0) | (anc >= C.NUM_STATES)).any()):
        raise ValueError("tb_walk: anchor states must lie in [0, 64)")
    lib = _build.load()
    err = lib.tb_walk_launch(
        regs.data_ptr(), None if anc is None else anc.data_ptr(),
        None if anck is None else anck.data_ptr(), B, K, ckpt, gap,
        rs.data_ptr(), TB_THREADS, regs.device.index or 0,
        ctypes.c_void_p(torch.cuda.current_stream(regs.device).cuda_stream))
    _build.check(lib, err, "tb_walk")
    tb_walk.launches += 1
    return rs


tb_walk.launches = 0


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


def _regs_bytes(rs: torch.Tensor, framebits: int, ckpt: int, gap: int,
                tail: int = C.TAIL_BITS, offset: int = 0) -> torch.Tensor:
    """Byte-granular assembly from survivor-register windows.

    Each checkpoint register holds the last 32 survivor input bits: its
    window plus >= 8 bits of the previous ones, so with ckpt <= 24 every
    output byte lies inside one register: byte i = (rs[k_i] >> p_i) & 255
    with (k_i, p_i) fixed by the shape. ``offset`` skips a front-padded
    region: data bit t of the frame lives at trellis step offset + t.
    """
    assert ckpt <= 24
    K, B = rs.shape
    nsteps = offset + framebits + tail
    i = np.arange(framebits // 8)
    tend = offset + 8 * i + 7              # time of the byte's last bit
    k = np.minimum(tend // ckpt, K - 1)
    wend = np.where(k < K - 1, (k + 1) * ckpt - 1, nsteps - 1)
    p = wend - tend                        # shift within register k
    assert (p >= 0).all() and (p + 7 <= 31).all()
    r = rs.index_select(0, torch.as_tensor(k, device=rs.device))
    shifts = torch.as_tensor(p.astype(np.int32), device=rs.device)
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
    """The checkpoint walk through ``tb_walk`` (kernel B on the card),
    then byte assembly. Bit-exact vs ``chainback_regs``.

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
    rs = tb_walk(regs, ckpt, gap, anchor, anchor_k)
    if ckpt <= 24:
        out = _regs_bytes(rs, framebits, ckpt, gap, tail=tail,
                          offset=offset)
    else:
        assert offset == 0
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
