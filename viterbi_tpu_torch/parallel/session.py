"""Stream sessions: decode a stream that arrives in chunks. The port of
``viterbi_tpu.parallel.session``.

``decode_stream`` needs the whole stream; a receiver gets 24 ms chunks
forever. A ``StreamSession`` takes symbol chunks as they arrive and
returns decoded bytes with bounded latency:

  * **exact metric carry**: the path metrics at the emit boundary are the
    values an ACS from the stream's start would have there (the boundary
    stays on an even, 24-aligned step, so the renormalization cadence is
    the global one), where the reference resets its metrics at every
    9216-bit call (deconvolve.cpp:97-100);
  * **truncated traceback**: each push decodes everything more than
    ``overlap`` steps behind the newest arrival, tracing back from the
    best end state: the overlap truncation of block-overlap streaming,
    with the reliability measured in OVERLAP_SWEEP.json;
  * **one upload a push**: pending symbols stay on the host as packed
    words (one int32 a step, a quarter of the bytes), the carried metrics
    stay on the device, and a push copies its words once, through a
    pinned buffer without blocking the host, then reads its bytes back.

With the kernels a push is three launches and no loop over steps on the
host: kernel A over the emit region from the carried metrics (its
checkpoints and the boundary metrics), kernel A again over the look-ahead
from those metrics, and one walk of kernel B over both stacks of
checkpoints, anchored at the best end state, that emits the region's
bytes. Both passes restart their registers from the state numbers, so
the first look-ahead checkpoint shifted past its window is the survivor's
state at the boundary, and the walk crosses into the emit region's
stack; it follows the same survivor path as the reference's decision walk
over the look-ahead. A flush is kernel A over the rest and the tail, then
kernel B from state 0. Without the kernels, the reference's form:
``acs.forward`` twice and ``_anchored_chainback``.

Chunks may be any even number of trellis steps (4 soft symbols a step):
every DAB chunk (framebits = bitrate * 24 a 24 ms logical frame) is.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import acs, acs_cuda
from ..ops import traceback as tb
from ..runtime.placement import strict_device, want_kernels
from .streaming import _anchored_chainback

EMIT_QUANTUM = 24   # emit boundaries land on multiples of 24 bits
                    # (lcm of byte granularity and the ckpt=24 walk)


def push_kernels(words: torch.Tensor, init: torch.Tensor, seg_a: int,
                 seg_b: int):
    """A push through kernels A, A and B (their plain versions on a CPU
    tensor). ``words``: int32[B, >= seg_a + seg_b] packed words, ``init``
    the metrics at their start. Returns (uint8[B, seg_a // 8] bytes of the
    emit region, the metrics at its end)."""
    q = EMIT_QUANTUM
    regs_a, m1 = acs_cuda.forward_regs(words, seg_a, initial_metrics=init,
                                       ckpt=q, packed="bt")
    regs_b, m2 = acs_cuda.forward_regs(words[:, seg_a:], seg_b,
                                       initial_metrics=m1, ckpt=q,
                                       packed="bt")
    gap = seg_b - (regs_b.shape[0] - 1) * q
    _, out = tb.tb_walk_bytes(torch.cat([regs_a, regs_b]), seg_a, q, gap,
                              tail=seg_b, anchor=tb.best_state(m2))
    return out, m1


def push_plain(words: torch.Tensor, init: torch.Tensor, seg_a: int,
               seg_b: int):
    """A push in the reference's plain form; as ``push_kernels``.
    Decisions carry a TAIL_BITS delay (the decision at step t decides bit
    t - 6), so the emit region's bits are rows [6, seg_a + 6) of the two
    passes' decisions: ``_anchored_chainback``'s block window."""
    dec_a, m1 = acs.forward(acs_cuda.unpack_symbols(words, seg_a, "bt"),
                            seg_a, init)
    dec_b, m2 = acs.forward(
        acs_cuda.unpack_symbols(words[:, seg_a:], seg_b, "bt"), seg_b, m1)
    n = seg_a + seg_b
    anchor_j = torch.full((words.shape[0],), n - 1, dtype=torch.int32)
    out = _anchored_chainback(torch.cat([dec_a, dec_b]), anchor_j,
                              tb.best_state(m2), n, seg_a)
    return out, m1


def flush_kernels(words: torch.Tensor, init: torch.Tensor,
                  rest: int) -> torch.Tensor:
    """The terminated end through kernels A and B: ``rest`` data steps and
    the tail from ``init``, walked from state 0. Returns uint8[B,
    ceil(rest/8)]; a partial last byte comes out of the walk's windows in
    plain torch."""
    regs, _ = acs_cuda.forward_regs(words, rest + C.TAIL_BITS,
                                    initial_metrics=init,
                                    ckpt=EMIT_QUANTUM, packed="bt")
    return tb.chainback_regs_cuda(regs, rest, ckpt=EMIT_QUANTUM)


def flush_plain(words: torch.Tensor, init: torch.Tensor,
                rest: int) -> torch.Tensor:
    """The terminated end in the reference's plain form."""
    n = rest + C.TAIL_BITS
    dec, _ = acs.forward(acs_cuda.unpack_symbols(words, n, "bt"), n, init)
    B = words.shape[0]
    return _anchored_chainback(dec, torch.full((B,), n - 1),
                               torch.zeros(B, dtype=torch.int32), n, rest)


class StreamSession:
    """Chunked-arrival decoder for one batch of parallel streams.

    ``push(symbols)`` takes int[B, 4*n] soft symbols (n trellis steps, n
    even) and returns the newly decoded uint8[B, k] bytes (k = 0 while the
    look-ahead fills). ``flush(tail_symbols)`` takes the 6 tail bits'
    symbols int[B, 24] of the terminated stream and returns every
    remaining byte. The concatenated output equals a one-shot decode of
    the whole stream within the overlap's reliability (module docstring).

    The session decodes on ``device``: the card unless the caller names
    another (``"cpu"``), and ``placement.NoDeviceError`` where there is
    none. ``use_kernels=None`` takes kernels A and B on the card and the
    plain form on the CPU.
    """

    def __init__(self, batch: int, overlap: int = 120,
                 use_kernels: bool | None = None, device=None):
        if overlap < C.TAIL_BITS:
            raise ValueError(f"overlap {overlap} < {C.TAIL_BITS}")
        self.B = batch
        self.overlap = int(overlap)
        self.device = strict_device(device)
        self.use_kernels = want_kernels(use_kernels, self.device)
        self.emitted_bits = 0                 # multiple of EMIT_QUANTUM
        self._metrics = None                  # on the device, or None
        self._buf = np.zeros((batch, 0), dtype=np.int32)  # packed words
        self._staging = None                  # pinned upload buffer
        self._done = False

    def _init_metrics(self) -> torch.Tensor:
        if self._metrics is None:
            return acs.init_metrics(self.B, self.device)
        return self._metrics

    def _upload(self, words: np.ndarray) -> torch.Tensor:
        """Packed words [B, n] to the device in one copy: on a card from a
        pinned buffer, without blocking the host. Every push and flush
        reads its bytes back before it returns, so the copy has finished
        before the buffer is written again."""
        if self.device.type != "cuda":
            return torch.from_numpy(words).to(self.device)
        if self._staging is None or self._staging.numel() < words.size:
            # twice the need: a push holds its chunk and up to overlap +
            # EMIT_QUANTUM steps left over, so pushes of equal chunks
            # after the first never pin memory again
            self._staging = torch.empty(2 * words.size, dtype=torch.int32,
                                        pin_memory=True)
        host = self._staging[:words.size].view(words.shape)
        host.numpy()[...] = words
        return host.to(self.device, non_blocking=True)

    def pending_steps(self) -> int:
        """Trellis steps taken in but not yet emitted."""
        return self._buf.shape[1]

    def push(self, symbols) -> np.ndarray:
        """Take a chunk; return the newly decoded bytes (uint8[B, k])."""
        if self._done:
            raise RuntimeError("session already flushed")
        chunk = np.asarray(symbols)
        if chunk.ndim != 2 or chunk.shape[0] != self.B \
                or chunk.shape[1] % (2 * C.RATE):
            raise ValueError(
                f"chunk must be [batch={self.B}, 4*steps] with an even "
                f"step count, got {chunk.shape}")
        self._buf = np.concatenate(
            [self._buf, acs_cuda.pack_symbols_host(chunk)], axis=1)
        avail = self.pending_steps()
        # emit everything more than `overlap` steps behind the newest
        # arrival, on EMIT_QUANTUM boundaries
        seg_a = ((avail - self.overlap) // EMIT_QUANTUM) * EMIT_QUANTUM
        if seg_a <= 0:
            return np.zeros((self.B, 0), dtype=np.uint8)
        push = push_kernels if self.use_kernels else push_plain
        out, self._metrics = push(self._upload(self._buf),
                                  self._init_metrics(), seg_a,
                                  avail - seg_a)
        self.emitted_bits += seg_a
        self._buf = self._buf[:, seg_a:]
        return out.cpu().numpy()

    def flush(self, tail_symbols) -> np.ndarray:
        """Take the 6 tail bits' symbols of the terminated stream and
        return every remaining byte (uint8[B, ceil(rest/8)])."""
        if self._done:
            raise RuntimeError("session already flushed")
        tail = np.asarray(tail_symbols)
        if tail.ndim != 2 or tail.shape != (self.B,
                                            C.RATE * C.TAIL_BITS):
            raise ValueError(
                f"tail must be [batch={self.B}, {C.RATE * C.TAIL_BITS}]")
        self._done = True
        rest = self.pending_steps()
        if rest == 0:
            return np.zeros((self.B, 0), dtype=np.uint8)
        words = np.concatenate(
            [self._buf, acs_cuda.pack_symbols_host(tail)], axis=1)
        flush = flush_kernels if self.use_kernels else flush_plain
        out = flush(self._upload(words), self._init_metrics(), rest)
        self.emitted_bits += rest
        self._buf = np.zeros((self.B, 0), dtype=np.int32)
        return out.cpu().numpy()
