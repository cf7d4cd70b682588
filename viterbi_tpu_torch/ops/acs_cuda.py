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
out even (``choose_layout``, ``_batch_tile``). Kernels A and C walk a
whole frame's trellis in one go, so there are no chunks to even out:
``decode`` runs the natural trellis with ``DECODE_CKPT`` = 24 and no
front pad, and the last checkpoint is partial when 24 does not divide
the trellis length. That makes every byte-aligned frame size decodable.
Checkpoints dominate kernel A's memory traffic (256 bytes per frame per
checkpoint, against 4 bytes of symbols per step), so the period is the
longest for which every output byte still lies inside one 32-bit
register (``traceback._regs_bytes``).

What bounds both kernels is the integer instruction rate, not bytes: a
scheduler of the card starts one integer instruction every other clock,
so a kernel's time is its instruction count as long as the schedulers
have warps. Each kernel therefore has two forms of the same device code,
and the wrapper takes the one that is faster at the batch it is given
(``REGS_ONE_LANE_FRAMES``, ``WORDS_ONE_LANE_FRAMES``). One lane a frame
keeps all 64 metrics (and, in kernel A, all 64 registers) in one thread
and runs the fewest instructions a frame, but gives the card's 528
schedulers one warp each only at 16384 frames: it is the form for the
largest batches. ``LANES`` = 4 neighbouring lanes of a warp a frame, 16
states each, put four times the warps on the schedulers and a quarter of
the instructions in a thread, at 1.6 to 1.8 times the instructions a
frame (every lane computes the branch metrics, and the states change
lanes): the form for everything below, down to one frame for kernel C
and to ``REGS_WARP_FRAMES`` for kernel A (below, its third form). The
lane of a state follows a schedule (``lane_of``, ``slot_of``,
``state_of``, the mirrors of the ``constexpr`` helpers in
``csrc/trellis.cuh``): at phase p
the lane is named by the state's bits [p, p + log2 LANES), a step takes
phase p to p + 1 without traffic between lanes, and after ``PHASES`` = 3
steps one exchange through shared memory brings every state back to
phase 0. A lane XORs the polarity of its own bits of the butterfly index
into the symbols (``polarity_word``) and indexes the eight branch metrics
by the rest. In both forms kernel A shifts its registers once a six-step
window (``register_select``, ``register_shift_in``) instead of once a
step.

Kernel A has a third form for the smallest batches, where one frame's
serial steps are the whole time: ``WARP_LANES`` = 32 lanes, a whole
warp, a frame. Lane l holds butterfly l, old states l and l + 32, in the
slot order of ``warp_state`` (an odd lane holds them swapped), and after
every step each lane sends its two new states by two shuffles, each to
the slot its reader keeps it in (``warp_source``, ``warp_sent``), so no
select follows a shuffle; a lane picks its branch metrics for the swap
(``warp_complement``) and breaks ties towards the high predecessor
whichever slot holds it. The frame's lanes share out what the other forms
compute in every lane: lane j holds the symbol word of step j of a
six-step chunk, and lane j computes the branch metric of pattern j & 7
for step j // 8 of a round of four steps (``warp_metric_lane``), which
each lane's butterfly then fetches. The wrapper takes the form below
``REGS_WARP_FRAMES``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from . import _build
from . import acs as acs_ops
from . import traceback as tb

DECODE_CKPT = 24   # checkpoint period of decode(); see the module docstring
LANES = 4          # lanes of a warp that share a frame: kLanes of trellis.cuh
PHASES = 3         # steps between two exchanges: kPhases of trellis.cuh
WARP_LANES = 32    # kernel A's warp-wide form: kWarpLanes of trellis.cuh
CHUNK = 6          # steps of a chunk of the warp-wide form: kChunk
ACS_THREADS = 128  # threads per block of kernel A
WORDS_THREADS = 128  # threads per block of kernel C
#: Batches from which one lane a frame is the faster form of kernel A and
#: of kernel C on an H100, set from the batch sweeps of both forms
#: (``probes/kbatch.py``, PERF.md): four lanes a frame cost 1.6 to 1.8
#: times the instructions a frame and win as long as one lane a frame
#: leaves the schedulers short of warps. Kernel A: 2.60 against 2.87 ms at
#: 24576 frames, 3.38 against 2.86 ms at 32768. Kernel C: 1.31 against
#: 1.34 ms at 10240, 1.68 against 1.35 ms at 16384.
REGS_ONE_LANE_FRAMES = 28672
WORDS_ONE_LANE_FRAMES = 12288
#: Batches below which kernel A takes its warp-wide form (``WARP_LANES``
#: lanes a frame), set from the sweep of its three forms
#: (``probes/kbatch.py``, ``sweep_small``; PERF.md): a frame's steps cost
#: one warp 0.044-0.050 us up to 512 frames against 0.18 with four lanes,
#: and the warp-wide form's time grows with its warps on the schedulers
#: while four lanes stay near 0.70 ms at 3072 bits up to 4096 frames.
#: 3072 bits: 0.6603 against 0.7018 ms at 3200 frames, 0.7929 against
#: 0.7046 at 4096; 768 bits: 0.1724 against 0.1830 at 4096.
REGS_WARP_FRAMES = 3584
#: parts of kernel A's step that ``forward_regs_plain(ablate=)`` and the
#: ablation probe's kernel can leave out
ABLATIONS = frozenset({"noreg", "norenorm", "nosat", "nobm"})


def lane_of(lanes: int, phase: int, state: int) -> int:
    """The lane that holds ``state`` at ``phase``: its bits [phase,
    phase + log2 lanes)."""
    return (state >> phase) & (lanes - 1)


def slot_of(lanes: int, phase: int, state: int) -> int:
    """The slot (register index) of ``state`` in its lane at ``phase``:
    the state with the lane's bits taken out."""
    lb = lanes.bit_length() - 1
    return (state & ((1 << phase) - 1)) | ((state >> (phase + lb)) << phase)


def state_of(lanes: int, phase: int, lane: int, slot: int) -> int:
    """The state in ``slot`` of ``lane`` at ``phase``."""
    lb = lanes.bit_length() - 1
    return (slot & ((1 << phase) - 1)) | (lane << phase) \
        | ((slot >> phase) << (phase + lb))


def warp_state(lane: int, slot: int) -> int:
    """The state in ``slot`` of ``lane`` in the warp-wide form: butterfly
    ``lane``'s low predecessor in slot ``lane & 1``, its high one (lane +
    32) in the other."""
    return lane | (((slot ^ lane) & 1) << 5)


def warp_source(lane: int, slot: int) -> int:
    """The lane whose ``slot``-th shuffle ``slot`` of ``lane`` reads after
    a step."""
    return (lane >> 1) | (((slot ^ lane) & 1) << 4)


def warp_sent(lane: int, slot: int) -> int:
    """u of the new state 2 * lane + u that ``lane`` sends in its
    ``slot``-th shuffle."""
    return ((lane >> 4) ^ slot) & 1


def warp_complement(lane: int) -> bool:
    """Whether slot 0 of ``lane`` takes the complement of the low
    predecessor's branch metric into the state the lane sends first."""
    return bool((lane ^ (lane >> 4)) & 1)


def warp_metric_lane(lane: int, step: int) -> int:
    """The lane that computes, in a round of branch metrics of the
    warp-wide form, the metric of ``lane``'s butterfly at step ``step`` of
    the round: lane j computes pattern j & 7 of the round's step j // 8."""
    return (step % (WARP_LANES // 8)) << 3 | pattern(lane)


def pattern(b: int) -> int:
    """Polarity pattern of butterfly ``b``: bit 2 <- g0 (== g3), bit 1 <-
    g1, bit 0 <- g2; linear over the bits of ``b``."""
    par = lambda x: bin(x).count("1") & 1
    g = C.POLYS
    return (par((b << 1) & g[0]) << 2) | (par((b << 1) & g[1]) << 1) \
        | par((b << 1) & g[2])


def pattern_word(q: int) -> int:
    """Polarity pattern ``q`` over a step's packed symbols: byte j is 255
    where symbol j is complemented."""
    return (0xFF0000FF if q & 4 else 0) | (0x0000FF00 if q & 2 else 0) \
        | (0x00FF0000 if q & 1 else 0)


def polarity_word(b: int) -> int:
    """The polarity of butterfly ``b`` over a step's packed symbols."""
    return pattern_word(pattern(b))


def eight_branch_metrics(words: torch.Tensor, flip: int = 0) -> torch.Tensor:
    """The eight distinct branch metrics of a step, as the kernels compute
    them: packed words [B] (int64 values in [0, 2^32)), XOR-ed with a
    lane's polarity word ``flip`` -> int32[B, 8], entry q for the
    butterflies of polarity pattern q."""
    w = words.to(torch.int64) ^ flip
    s = [(w >> (8 * q)) & 255 for q in range(4)]
    avg = lambda x, y: (x + y + 1) >> 1
    out = []
    for q in range(8):
        x0, x1, x2 = (255 if q & 4 else 0), (255 if q & 2 else 0), \
            (255 if q & 1 else 0)
        out.append(avg(avg(s[0] ^ x0, s[1] ^ x1),
                       avg(s[2] ^ x2, s[3] ^ x0)) >> 2)
    return torch.stack(out, dim=-1).to(torch.int32)


def register_select(regs: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """The register exchange of one step without its shift: new state
    2b + u takes the register of b (decision 0) or b + 32 (decision 1).
    regs int32[B, 64], dec bool[B, 64]."""
    lo = regs[:, :32].repeat_interleave(2, dim=1)
    hi = regs[:, 32:].repeat_interleave(2, dim=1)
    return torch.where(dec, hi, lo)


def register_step(regs: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """One step of the survivor registers: select, shift left by one,
    bring the state's input bit in."""
    odd = torch.arange(C.NUM_STATES, dtype=torch.int32,
                       device=regs.device) & 1
    return (register_select(regs, dec) << 1) | odd


def register_shift_in(regs: torch.Tensor, n: int) -> torch.Tensor:
    """The deferred shift after ``n`` <= 6 select-only steps: the low n
    bits of a survivor's register are the low n bits of its state."""
    state = torch.arange(C.NUM_STATES, dtype=torch.int32, device=regs.device)
    return (regs << n) | (state & ((1 << n) - 1))


def pack_symbols(symbols: torch.Tensor, nsteps: int) -> torch.Tensor:
    """[B, >=4*nsteps] soft symbols -> time-major packed [nsteps, B] int32:
    one trellis step's four symbols in one word, symbol j in byte j (each
    symbol's low byte: integer casts wrap modulo 256)."""
    s = symbols[:, : 4 * nsteps].to(torch.uint8).contiguous()
    return s.view(torch.int32).T


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


def _lanes(B: int, one_lane_frames: int, lanes: int | None,
           warp_frames: int = 0) -> int:
    """Lanes a frame for a batch of ``B``: the caller's, or ``WARP_LANES``
    below ``warp_frames`` (kernel A's; a kernel without the warp-wide form
    gives 0 and refuses it), ``LANES`` below ``one_lane_frames`` and 1
    from there on."""
    forms = (1, LANES, WARP_LANES) if warp_frames else (1, LANES)
    if lanes is None:
        return WARP_LANES if B < warp_frames else \
            1 if B >= one_lane_frames else LANES
    if lanes not in forms:
        raise ValueError(f"lanes must be one of {forms}, got {lanes}")
    return lanes


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
                       front_pad: int = 0, ablate=frozenset()):
    """Plain version of kernel A, batch-vectorized over [B, 64].

    Same arguments and results as ``forward_regs``. Registers shift by
    one input bit per step (kernel A, like the TPU kernels, defers a shift
    by 6 per six-step window; the values at every checkpoint are the same).

    ``ablate`` leaves parts of the step out, as the ablation probe's
    kernel does (``probes.kablate``): ``"noreg"`` (the registers keep
    their seeds), ``"norenorm"``, ``"nosat"``, ``"nobm"`` (the branch
    metric is symbol byte 0 for every butterfly).
    """
    unknown = set(ablate) - ABLATIONS
    if unknown:
        raise ValueError(f"unknown ablation {sorted(unknown)}")
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
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=dev)
    metrics, regs = init, state_idx.expand(B, -1)
    out = torch.empty((K, C.NUM_STATES, B), dtype=torch.int32, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    for t in range(total):
        if t == reset_at:
            metrics, regs = init, state_idx.expand(B, -1)
        w = zero if t < front_pad else words[t - front_pad]
        s4 = (w[:, None] >> shifts) & 255                        # [B, 4]
        bm = s4[:, :1].expand(-1, 32) if "nobm" in ablate \
            else acs_ops.branch_metrics(s4)
        metrics, dec = acs_ops.acs_step(metrics, bm,
                                        saturate="nosat" not in ablate)
        if "noreg" not in ablate:
            regs = register_step(regs, dec)
        if t % 2 == 1 and "norenorm" not in ablate:
            metrics = acs_ops.renormalize(metrics)
        if (t + 1) % ckpt == 0 or t + 1 == total:
            out[-(-(t + 1) // ckpt) - 1] = regs.T
    return out, metrics


def forward_regs(symbols: torch.Tensor, nsteps: int,
                 initial_metrics: torch.Tensor | None = None,
                 ckpt: int | None = None, packed: bool | str = False,
                 front_pad: int = 0, lanes: int | None = None):
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
    the launch is counted under its form. ``lanes`` names the kernel's
    form, 1, ``LANES`` or ``WARP_LANES`` lanes a frame; left out, the
    batch decides (``REGS_WARP_FRAMES``, ``REGS_ONE_LANE_FRAMES``). The
    results are the same.
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
    lanes = _lanes(B, REGS_ONE_LANE_FRAMES, lanes, REGS_WARP_FRAMES)
    regs = torch.empty((K, C.NUM_STATES, B), dtype=torch.int32, device=dev)
    metrics = torch.empty((B, C.NUM_STATES), dtype=torch.int32, device=dev)
    if B == 0:
        return regs, metrics
    _build.ACS_REGS.launch(
        dev, sym.data_ptr(), sb, st, unpacked, init.data_ptr(), B, total,
        front_pad, reset_at, ckpt, regs.data_ptr(), metrics.data_ptr(),
        lanes, ACS_THREADS, form=lanes)
    return regs, metrics


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
            packed: bool | str = False, lanes: int | None = None):
    """The decisions forward pass, twin of ``acs_pallas.forward``.

    ``symbols`` in any ``forward_regs`` layout: unpacked [B, >=4*nsteps],
    time-major packed [>=nsteps, B] (``packed=True``) or frame-major
    packed [B, >=nsteps] (``packed="bt"``). ``nsteps`` is even (the
    renormalization cadence). Returns (decisions int32[nsteps, B, 2],
    final_metrics int32[B, 64]): bit s of word s//32 is the decision into
    state s, as int32 bit patterns.

    Kernel C on a CUDA tensor, ``forward_plain`` on a CPU tensor.
    ``lanes`` names the kernel's form, 1 or ``LANES`` lanes a frame; left
    out, the batch decides (``WORDS_ONE_LANE_FRAMES``). The results are
    the same.
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
    lanes = _lanes(B, WORDS_ONE_LANE_FRAMES, lanes)
    dec = torch.empty((nsteps, B, 2), dtype=torch.int32, device=dev)
    metrics = torch.empty((B, C.NUM_STATES), dtype=torch.int32, device=dev)
    if B == 0:
        return dec, metrics
    _build.ACS_WORDS.launch(
        dev, sym.data_ptr(), sb, st, unpacked, init.data_ptr(), B, nsteps,
        dec.data_ptr(), metrics.data_ptr(), lanes, WORDS_THREADS)
    return dec, metrics


def decode(symbols: torch.Tensor, framebits: int,
           packed: bool | str = False,
           initial_metrics: torch.Tensor | None = None) -> torch.Tensor:
    """Fused end-to-end decode: ``forward_regs`` + checkpoint walk.

    ``symbols`` in any ``forward_regs`` layout; ``framebits`` a multiple
    of 8; ``initial_metrics`` as ``forward_regs`` takes them (a caller
    that keeps them makes no fill a call). Returns uint8[B, framebits //
    8] MSB-first packed bytes on the symbols' device.
    """
    if framebits <= 0 or framebits % 8:
        raise ValueError(f"decode needs framebits % 8 == 0, got {framebits}")
    nsteps = framebits + C.TAIL_BITS
    regs, _ = forward_regs(symbols, nsteps, initial_metrics,
                           ckpt=DECODE_CKPT, packed=packed)
    return tb.chainback_regs_cuda(regs, framebits, ckpt=DECODE_CKPT)
