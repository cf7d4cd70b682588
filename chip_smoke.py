#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's decode paths once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):
  1. device: require a CUDA device; print the card's name and power limit;
  2. build: compile the decode kernels and the probes' kernels from
     viterbi_tpu_torch/csrc with nvcc, both libraries at the same time;
     kernels A, C and E, in both forms (one lane a frame and four; A also
     in its warp-wide form, 32 lanes a frame), must spill nothing; kernel I must spill nothing, and in both syndrome
     forms use at most 64 registers a thread for RS(120,110); kernel I's
     RS(204,188) entry and kernel K must spill nothing;
  3. kernels: kernel A (fused register-exchange ACS) and kernel B
     (checkpoint walk), kernel C (decisions) and kernel D (decision-word
     walk) against their plain torch versions on the card, bit for bit,
     over the frame sizes, layouts and anchors the decode paths can hand
     them; A and C in the form the batch selects and in each form by
     name, also at batches that leave the last warp ragged, with a reset
     inside a six-step window and at every checkpoint period; B in every
     form (1 to 32 segments a frame) on random registers, whose walks
     never merge, and on kernel A's, with anchors, at 1 to 129
     checkpoints, and its byte output against _regs_bytes of the plain
     walk; kernel K (the T-DMB deinterleaver) at the chain calls of
     tdmb_stream.bulk (8 streams x 100 CIFs x 8 packets, 16 x 100 x 4),
     fresh and continuing its carry, and kernel I's RS(204,188) entry
     on 6400 clean, dirty (1 to 8 byte errors) and 12-error codewords,
     contiguous and strided; one launch a call each, timed in a replayed
     graph;
  4. main path: initialize() must pick the cuda_fused rung; decode
     B=16384 noisy frames of 3072 bits through
     deconvolve_batch(packed=True), bit-equal to the golden model and
     to the torch_scan rung (kernel C and the plain serial walk), then
     the DAB bitrate ladder and one scalar deconvolve; kernels A and B
     must be launched;
  5. words path: with the override at 2, initialize() must pick the
     cuda_words rung; the same frames, unpacked and packed, bit-equal to
     the cuda_fused output and to golden, the packed call timed (it
     copies the packed words: phase 7 holds it under three times the
     cuda_fused call); framebits 64 through the blocked fallback; kernels
     C and D must be launched; then the torch_blocked rung on the same
     frames;
  6. harness: viterbi_tpu_torch.harness.benchmark at /f 5000 /t 10 on
     all four rungs: every rung must decode 2637 bit errors in 595 bad
     frames, the Eb/N0 sweep 1321 / 55 / 11 errors equal to golden, and
     fault injection must pass;
  7. times: both paths end to end; each kernel against its plain
     version on the main-path batch, timed and held bit for bit; the
     main path's output against a decode through plain versions only
     (forward_plain, then tb_words_plain); kernel A at one frame of 3072
     bits (a live call's unpacked symbols) in its warp-wide and its
     four-lane form, held bit for bit, ms and us a step in a replayed
     graph (kernel A's row, "one_frame"); the batch sweep of kernels A
     and C in every form and, at four batches, of kernel B in every form
     (probes.kbatch); kernel B's row is the walk with the bytes in the
     same launch, as the main path runs it, and beside it stand the walk
     alone and its loads as one independent gather, the card's floor for
     them;
  8. superframe path: 2048 DAB+ audio superframes at 128 kbit/s (10240
     frames, 32768 RS codewords) through
     models.dab.decode_audio_superframes on the card: kernels A and B
     and kernel I's superframes entry (once: the RS stage is one launch)
     must be launched, the audio equal to what was encoded wherever the
     error count is not -1, audio and counts equal to the golden model
     and to the CPU's plain path on subsets, and on the whole batch to
     the same call through plain versions only on the card; kernels A
     and B against their plain versions on the path's own symbols;
     kernel I on the path's own uint8 superframes against its plain
     version (both entries, both fills, and the probe's table syndrome
     form); rates and the split Viterbi / assembly / RS stage;
  9. RS: rs_check_superframe through the API for rs_dims 1, 4, 16, 48,
     clean, corrected and -1 with the partial prefix write, against
     golden, kernel I once a call and at most three device operations
     (the copy up, the kernel, the copy back); kernel I against its plain
     version on every case; each call's ms; then probes.rsform: the table
     and the bitwise form of the field arithmetic and kernel I's
     codewords entry in both syndrome forms at 65536 codewords on three
     error mixes, all four equal and timed; probes.rsphases: kernel I's
     steps timed by the card's clock in each block, its output equal to
     the plain version; then deconvolve of one frame at each DAB+ size
     (the ladder and 48 kbit/s): every call against golden, the median
     ms a call on the eager path (the size's plan held busy) and
     replayed, kernels A and B once a replay, the plans' captures and
     replays;
 10. EEP path: decode_punctured_frames at 128 kbit/s for EEP 3-A and
     2-B, and decode_profile_frames with a four-segment row, against
     golden on a subset and, on the whole batch, against the plain path
     on the card; kernels A and B against their plain versions on the
     depunctured symbols; then the superframe chain fed punctured
     symbols (decode_audio_superframes with protection) once per EEP-A
     level at 128 kbit/s, a staged batch through kernels J, A, B and I
     (one launch each), against the plain-only call on the card and the
     plain reference (reference/punctured.py) on two superframes;
     kernel J against its plain version on the path's bytes, timed at
     EEP 3-A; then models.tdmb.decode_ts_streams on 8 streams at 544
     kbit/s over 14 CIFs in two calls carrying the state: kernels J, A,
     B, K and I's packets entry once a call, equal to the plain-only
     calls on the card, with corrected and uncorrectable packets;
 11. replay: the committed corpus replays bit-exactly;
 12. probes: kernels E to H against their plain versions, bit for bit,
     at the probes' own shapes (F also at lane counts around one thread's
     16 bytes and on views that are not 16-byte aligned), the launch
     path's five times (torch.add, the wrapper's launch, the bare C call,
     and both inside a replayed CUDA graph), then each probe's table;
 13. tail-biting: 16384 tail-biting frames of 3072 bits at 3 dB through
     ops.tailbiting.decode_tailbiting (kernels C, A and B must launch
     once each), equal to the plain path on the card and to golden on 12
     frames; kernels C, A and B against their plain versions on the
     path's own inputs; a batch with forced end-metric ties (argmin takes
     the lowest state on the card), the tie fixture, framebits 8, 32 and
     9216;
 14. streaming (viterbi_tpu_torch.tools.stream.cell):
     make_local_stream_decoder at the shapes of STREAM_TPU.json (64
     streams of 96 blocks of 3072 bits, 256 of 24) and with a block whose
     overlap the layout rounds (480 bits): two launches of kernel A and
     one of kernel B a call, equal to the plain path on the card and on 4
     streams to the whole-stream decode through kernels A and B; kernel A
     against its plain version on the call's inputs, kernel B in every
     form on the call's anchors, which lie below the top checkpoint;
     Gsym/s beside cuda_fused's kernels;
 15. session (tools.session): StreamSession on 64 streams of 3072-bit
     chunks (128 kbit/s), 40 pushes and a flush, then chunks of 5 frames:
     equal to the one-shot decode through kernels A and B, three launches
     a push, push time p50 under the 24 ms frame (and its max), the
     emitted-bit lag; kernels A and B against their plain versions on the
     last push; the plain session on the CPU equal on 2 streams;
 16. host ingest (tools.ingest): libvitio.so built from native/vitio.cpp
     and equal to its numpy fall-backs, a frame ring fed by 4 threads, and
     utils.pipeline.decode_pipelined over 8 packed 16384 x 3072 batches
     through acs_cuda.decode at depth 1 and 2, equal to one call at a
     time, timed in turns with one pageable call at a time, eight runs
     each: the median and the range;
 17. several processes on one card: four ranks spawned on cuda:0 over
     gloo (parallel.distributed.run_ranks, each job under a wall-clock
     limit). parallel.batch.decode_sharded of the main-path batch over 2
     ranks, bit-equal to phase 4's output and to golden on 8 frames;
     parallel.streaming.decode_stream of 64 streams of 294 912 bits on
     meshes (1, 2), (1, 4) and (2, 2), bit-equal to
     make_local_stream_decoder(n_blocks=n_seq) on the card, and a small
     ring (4 x 3072-bit blocks, 4 streams) whose kernel A and B calls are
     held against their plain versions in each rank;
     models.dab.decode_ensemble_sharded of phase 8's 2048 superframes over
     2 ranks, bit-equal to phase 8's one-process output. Kernels A and B
     must launch in every rank of each path; each path's wall time and
     device part. Then harness.scaling's sweep at 1, 2 and 4 ranks of
     4096 frames of 3072 bits each, with its envelope (a record);
 18. entry points and evidence tools: viterbi_tpu_torch.entry.entry()
     (kernels A and B, equal to golden and to its plain form on the CPU),
     entry.dryrun_multichip(4) on cuda:0 (kernels A and B launched in every
     path of every rank), tools.parity --quick (twelve sections, 0
     mismatches, every kernel of ops.counts launched, the T-DMB chain's
     K and I's packets entry among them) and tools.overlap_sweep at 0 dB,
     seed 0, overlaps 24 and 96 (the plain form equal to
     OVERLAP_SWEEP.json's cells, the kernel form equal to the plain form
     at its effective overlap);
 19. first use: in a fresh python3 process, with no initialize() call,
     deconvolve_batch of 64 frames of 3072 bits must set the dispatcher
     up on the card with the cuda_fused rung, launch kernels A and B once
     each and equal golden on 4 frames; rs_check_superframe must launch
     kernel I once and equal golden; decode_audio_superframes of a host
     array with no device must return tensors on the card, equal to the
     plain path on the CPU; a StreamSession with no device must be on the
     card.
Phases 13-15 also time each launch of their call alone.
The last line of output is {"ok": true, "device": {...}}; the line
before it lists the thirteen kernels as JSON, each with its launches on its
path (A to D and I also by path, phases 8-18 included; I by both its
entries), its time beside its plain version's, and its bound: the larger
of the bytes it must move over 3.35 TB/s and its integer operations (the
shortest sequence that computes the step; an add feeding a min counts as
one, as the card fuses them) over the card's issue rate, or for kernel
I's syndromes the binary product over the int8 tensor rate.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B_MAIN = 16384          # frames per main-path call
FB_MAIN = 3072          # framebits of the main-path call (128 kbit/s)
B_CHECK = 1024          # frames per kernel-vs-plain check
EEP_SF = 512            # superframes a punctured chain call (phase 10)
# T-DMB (phases 3 and 10): tdmb_stream.bulk's chain calls, (streams,
# packets a CIF) of its 544 and 272 kbit/s groups over 100 CIFs; the
# byte errors of kernel I's RS(204,188) check and their shares; the
# chain's streams and CIFs at 544 kbit/s
TS_GROUPS = ((8, 8), (16, 4))
TS_CALL_CIFS = 100
TS_MIX = {0: 0.4, **dict.fromkeys(range(1, 9), 0.07), 12: 0.04}
TS_STREAMS, TS_CIFS = 8, 14
EBN0_DB = 3.0
# the harness gate's exact counts on its seeded frames (HARNESS_TPU.json)
GATE = {"frames": 5000, "bit_errors": 2637, "bad_frames": 595}
SWEEP_ERRORS = {"2.0": 1321, "3.0": 55, "4.0": 11}
# kernel C's check sizes: the seven DAB bitrates, the non-6 trellis class
# (64 -> nsteps 70), 96 and an odd bitrate (97 kbit/s -> 2328)
WORDS_FRAMEBITS = (192, 768, 1536, 2304, 3072, 4608, 9216, 64, 96, 2328)
WALK_FRAMEBITS = (24, 48, 768, 2328, 9216)   # kernel D's check sizes
SF_KBPS = 128           # the superframe path's subchannel (rs_dims 16)
B_SF = 2048             # superframes per call: 10240 frames, 32768 codewords
SF_BAD = 8              # superframes with nine byte errors in one codeword
SF_GOLDEN = 12          # superframes held against the golden model
SF_PLAIN = 4            # superframes held against the CPU's plain path
E_BATCH = 8192          # the ablation probe's batch (framebits FB_MAIN)
# batches that leave the last warp ragged, for the forms of kernels A and
# C whose lanes talk to each other
RAGGED = (1, 3, 7, 9, 31, 33, 1000)
# kernel B's forms: the batch's choice, then segments a frame by name
WALK_FORMS = (None, 1, 2, 4, 8, 16, 32)
# (checkpoints, ckpt, gap) of kernel B's checks on random registers: one
# checkpoint, fewer than the segments, an odd count, the main path's 129
WALK_SHAPES = ((1, 24, 6), (2, 14, 14), (5, 24, 24), (33, 14, 2),
               (129, 24, 6))
WALK_SWEEP = (1, 1024, 16384, 65536)    # batches of kernel B's sweep here
TB_FRAMES = 16384       # tail-biting frames of FB_MAIN bits (phase 13)
TB_WRAP = 96            # their warm-up steps
TB_GOLDEN = 12          # of them held against the golden model
# phase 14 (streams, blocks, block bits): the shapes of STREAM_TPU.json,
# 6144 folded frames each, then a block whose overlap the layout rounds
# (480 bits: checkpoint 18, overlap 132)
STREAM_CELLS = ((64, 96, 3072), (256, 24, 3072), (256, 16, 480))
SESSION_STREAMS = 64    # phase 15: 128 kbit/s streams of FB_MAIN-bit chunks
SESSION_PUSHES = 40
SESSION_FRAMES = 5      # frames a chunk in the second run
SESSION_PLAIN = (2, 4)  # streams and pushes of the plain session (CPU)
FRAME_MS = 24.0         # a DAB logical frame: the push's budget
RING_FRAMES = 8192      # phase 16: frames through the native ring
INGEST_BATCHES = 8      # packed B_MAIN x FB_MAIN batches pipelined
INGEST_ROUNDS = 4       # rounds of serial, 1, 2, 2, 1, serial in turns
# phase 17: several processes on one card, over gloo
RANKS = 4               # ranks spawned; a smaller mesh takes the first ones
SHARD_RANKS = 2         # ranks of the data-parallel decode and the ensemble
RING_MESHES = ((1, 2), (1, 4), (2, 2))    # (n_data, n_seq) of the ring
RING_STREAMS, RING_BITS = 64, 294912      # STREAM_TPU.json's first shape
RING_HOLD_ROWS = 4      # frames of each ring call held to the plain versions
RING_HOLD = (4, 4, 3072)  # (streams, seq ranks, block bits): a small ring
SWEEP_FRAMES = 4096     # frames a rank in the scaling sweep
RANK_LIMIT_S = 300      # wall-clock limit of one spawned job
GROUP_TIMEOUT_S = 120   # a rank's longest wait for a peer
FIRST_USE_LIMIT_S = 300  # phase 19's fresh process, kernel load included

# The card's peaks for the bounds: memory rate (data sheet), and issue
# rates per SM and clock: 64 int32 lanes, 128 float32 lanes (an add or a
# min is one operation; the 67 TFLOP/s of the data sheet count an FMA
# as two).
HBM_BYTES_S = 3.35e12
SMS = 132
INT_LANES, FP32_LANES = 64, 128
INT8_TENSOR_OPS_S = 1979e12   # dense int8 tensor rate (data sheet)
# Integer operations per trellis step and frame for the bounds, counted
# from csrc/trellis.cuh and the kernels as the shortest instruction
# sequence the card has: an add that feeds a min or max is one operation
# (Hopper's fused add-min, which the probes show at full issue rate), a
# three-input add is one, a shift-and-or by constants is one. Branch
# metrics: the eight patterns share their parts, so 4 complements of a
# symbol (xor 255), then avg(s0^x0, s1^x1) and avg(s2^x2, s3^x0) with 4
# distinct values each = 8 pair averages of 2 (a+b+1, shift), then 8
# final averages whose shift takes the >> 2 along (a+b+1, >> 3) = 16:
# 36 in all, + 4 to unpack the word, + 8 complements (63 - m).
# Renormalization: (1 compare + 64 fused sub-max) every other step =
# 32.5. A butterfly's two survivors take five operations each, since
# only the high path needs its cap (csrc/trellis.cuh, survivor): the low
# path's add, the high path's capped add, the min of the two, and in
# kernel A the compare and the select of the register, in kernel C the
# difference and the funnel shift that brings its sign into the word:
# 10 a butterfly. Kernel A shifts its 64 registers once a six-step
# window (64 / 6 a step); kernel C inverts its two words once a step.
BRANCH_METRIC_OPS = 4 + 8 * 2 + 8 * 2
STEP_COMMON_OPS = BRANCH_METRIC_OPS + 4 + 8 + 32.5
OPS_PER_STEP_A = 32 * 10 + 64 / 6 + STEP_COMMON_OPS
OPS_PER_STEP_C = 32 * 10 + 2 + STEP_COMMON_OPS
OPS_PER_ROUND_G = 3     # two fused add-mins and a xor
OPS_PER_ROUND_H = 2     # int: two fused add-mins a stream (float: 4 ops)
OPS_PER_CKPT_B = 6      # address (3), shift, mask, anchor compare
OPS_PER_BYTE_B = 5      # checkpoint of the byte (2), shift, mask, place
OPS_PER_BIT_D = 9       # word select, 2 shifts + 2 masks, 2 to place, 2 state
OPS_PER_STEP_J = 8      # a step's word: 4 selects (kept or 127), 4 shift-ors
# Kernel I: the operations the reference's scalar decoder
# (golden.rs_decode_codeword) needs on this run's codewords, each a step
# through the tables as csrc/rs_decode.cu takes it (a product of two logs
# is an add and a lookup). Syndromes through the tables: a byte's log
# lookup, then for each of the ten roots an exponent add, an antilog
# lookup and an XOR (the exponents i * (119 - j) are the same for every
# codeword); kernel I takes them instead as the 960 x 80 GF(2) product on
# the tensor cores, an AND and an add a bit pair, at the int8 tensor rate
# (OPS_RS_SYND_TENSOR a codeword). A codeword
# whose syndromes are not all zero adds Berlekamp-Massey's ten rounds (per
# round r: r products of 3 with their XORs, then 11 of x * b(x)'s and 11
# swapped coefficients, 990 in all) and the Chien search: at each element
# it visits, up to its deg-lambda-th root, an add, a lookup and an XOR for
# each nonzero coefficient of lambda past the first. A correctable one
# adds omega's d(d+1)/2 products of 4 (d = deg lambda) and, at each root
# past the pad, Forney's d terms of the numerator and the denominator's
# terms (even i up to min(d, 9)), 3 each, and the value's 5; omega and
# Forney at their loops' lengths, where the reference skips a zero
# coefficient's term.
OPS_RS_SYND_BYTE = 1 + 10 * 3
OPS_RS_SYND_TENSOR = 2 * 960 * 80
OPS_RS_BM = 990
OPS_RS_TERM = 3
OPS_RS_PRODUCT = 4
OPS_RS_VALUE = 5


def rs_decoder_ops(blocks) -> dict:
    """The operations above on ``blocks`` [..., 120], from what the
    reference's decoder does on each (ops.rs.decoder_work): the syndromes'
    through the tables (``synd_table``, integer) and as the tensor cores'
    product (``synd_tensor``), and the dirty codewords' (``dirty``,
    integer)."""
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch.ops import rs as rs_ops
    w = rs_ops.decoder_work(blocks)
    d = w["deg_lambda"]
    n = d.numel()
    den_terms = (d.clamp(max=9) & ~1) // 2 + 1
    dirty = ((w["dirty"] * (OPS_RS_BM + OPS_RS_TERM * w["chien"]
                            * w["terms"])).sum()
             + (w["correctable"] * OPS_RS_PRODUCT * d * (d + 1) // 2).sum()
             + (w["forney"] * (OPS_RS_TERM * (d + den_terms)
                               + OPS_RS_VALUE)).sum())
    return {"synd_table": n * C.RS_N * OPS_RS_SYND_BYTE,
            "synd_tensor": n * OPS_RS_SYND_TENSOR, "dirty": int(dirty)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bound(nbytes: float, int_ops: float, clock_hz: float,
          fp_ops: float = 0.0, tensor_ops: float = 0.0) -> dict:
    """The least time the card could take, as a kernel row's bound keys:
    ``bound_ms`` is the larger of the bytes over the memory rate
    (``bound_bytes_ms``) and the operations over the issue rate of their
    type, integer, float and integer tensor pipes side by side
    (``bound_ops_ms``); ``bound_by`` says which."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_S
    by_ops = 1e3 * max(int_ops / (INT_LANES * SMS * clock_hz),
                       fp_ops / (FP32_LANES * SMS * clock_hz),
                       tensor_ops / INT8_TENSOR_OPS_S)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes_ms": by_bytes, "bound_ops_ms": by_ops}


def ptxas_summary(log: str) -> dict:
    """{kernel name: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v output, one entry per instantiation."""
    found, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name] = (int(m.group(1)), *spills)
    return found


def max_abs_err(got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long().to(got.device)).abs().max().item())


def cuda_ms(fn, iters: int):
    """Mean device time of ``fn`` over ``iters`` back-to-back runs, and
    the output of a first, untimed run."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, out


def window_bytes(rs):
    """24-bit windows int32[W, B], data bit t at bit 23 - t%24 of window
    t//24, -> MSB-first packed bytes uint8[B, 3W] on the host."""
    import torch
    shifts = torch.tensor([16, 8, 0], dtype=torch.int32, device=rs.device)
    b = (rs[:, None, :] >> shifts[None, :, None]) & 255      # [W, 3, B]
    return b.to(torch.uint8).permute(2, 0, 1).reshape(rs.shape[1], -1) \
        .cpu().numpy()


FORMS = (None, 1, 4)     # kernels A and C: the batch's choice, then by name
REGS_FORMS = (*FORMS, 32)   # kernel A also a warp a frame


def hold_forward(dev, rng, check, batch, fb, packed, pad=0, ckpt=None,
                 with_init=True, words_too=True) -> None:
    """Kernels A and C in every form against their plain versions on one
    shape, bit for bit."""
    import torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch.ops import acs_cuda
    n = fb + C.TAIL_BITS
    raw = rng.integers(0, 256, (batch, C.RATE * n), dtype=np.int32)
    if packed:
        words = acs_cuda.pack_symbols_host(raw)
        raw = words if packed == "bt" else np.ascontiguousarray(words.T)
    syms = torch.from_numpy(raw).to(dev)
    init = (torch.from_numpy(rng.integers(0, 256, (batch, 64))
                             .astype(np.int32)).to(dev)
            if with_init else None)
    what = (f"B={batch}, framebits {fb}, packed={packed}, front_pad={pad}, "
            f"ckpt={ckpt}")
    kw = dict(initial_metrics=init, packed=packed, front_pad=pad, ckpt=ckpt)
    r_p, m_p = acs_cuda.forward_regs_plain(syms, n, **kw)
    for lanes in REGS_FORMS:
        r_k, m_k = acs_cuda.forward_regs(syms, n, lanes=lanes, **kw)
        check("acs_regs", r_k, r_p, f"{what}, lanes={lanes} regs")
        check("acs_regs", m_k, m_p, f"{what}, lanes={lanes} metrics")
    if not words_too:
        return
    d_p, m_p = acs_cuda.forward_plain(syms, n, init, packed)
    for lanes in FORMS:
        d_k, m_k = acs_cuda.forward(syms, n, init, packed, lanes=lanes)
        check("acs_words", d_k, d_p, f"{what}, lanes={lanes} decisions")
        check("acs_words", m_k, m_p, f"{what}, lanes={lanes} metrics")


def one_frame_times(dev, tag, check) -> dict:
    """Kernel A at one frame of FB_MAIN bits on unpacked int32 symbols (a
    live call's): the warp-wide and the four-lane form, each held bit for
    bit and timed in a replayed CUDA graph, in ms and in us a step."""
    import torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.probes import _common
    n, ck = FB_MAIN + C.TAIL_BITS, acs_cuda.DECODE_CKPT
    raw = np.random.default_rng(21).integers(0, 256, (1, C.RATE * n),
                                             dtype=np.int32)
    syms = torch.from_numpy(raw).to(dev)
    r_p, m_p = acs_cuda.forward_regs_plain(syms, n, ckpt=ck)
    row = {"framebits": FB_MAIN, "batch": 1, "ms": {}, "us_per_step": {}}
    for lanes in (acs_cuda.WARP_LANES, acs_cuda.LANES):
        r_k, m_k = acs_cuda.forward_regs(syms, n, ckpt=ck, lanes=lanes)
        what = f"B=1, framebits {FB_MAIN}, unpacked, lanes={lanes}"
        check("acs_regs", r_k, r_p, what + " regs")
        check("acs_regs", m_k, m_p, what + " metrics")
        ms = _common.graph_ms(lambda: acs_cuda.forward_regs(
            syms, n, ckpt=ck, lanes=lanes), 50)
        row["ms"][lanes] = ms
        row["us_per_step"][lanes] = 1e3 * ms / n
    print(f"{tag} acs_regs at B=1 framebits={FB_MAIN}, unpacked: " + ", ".join(
        f"{lanes} lanes {row['ms'][lanes]:.4f} ms, "
        f"{row['us_per_step'][lanes]:.5f} us a step" for lanes in row["ms"]))
    return row


def hold_walk(dev, rng, check, regs, ckpt, gap, what) -> None:
    """Kernel B in every form against its plain version on one set of
    checkpoints: terminated, anchored, anchored at an interior
    checkpoint."""
    import torch
    from viterbi_tpu_torch.ops import traceback as tb
    K, _, batch = regs.shape
    anc = torch.from_numpy(rng.integers(0, 64, batch).astype(np.int32)) \
        .to(dev)
    anck = torch.from_numpy(rng.integers(0, K, batch).astype(np.int32)) \
        .to(dev)
    for a, ak in ((None, None), (anc, None), (anc, anck)):
        want = tb.tb_walk_plain(regs, ckpt, gap, a, ak)
        for segments in WALK_FORMS:
            check("tb_walk",
                  tb.tb_walk(regs, ckpt, gap, a, ak, segments=segments),
                  want, f"{what}, anchor={a is not None}, anchor_k="
                        f"{ak is not None}, segments={segments}")


def check_walk_forms(rng, dev, check) -> None:
    """Phase 3, kernel B: every form on random registers (walks that never
    merge, so every segment walks again until the serial order is
    restored) and on kernel A's, at ragged batches; then the bytes."""
    import torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import traceback as tb
    for batch in (*RAGGED, B_CHECK):
        for K, ckpt, gap in WALK_SHAPES:
            regs = torch.from_numpy(rng.integers(
                -2**31, 2**31, (K, 64, batch), dtype=np.int64)
                .astype(np.int32)).to(dev)
            hold_walk(dev, rng, check, regs, ckpt, gap,
                      f"random registers B={batch} K={K} ckpt={ckpt}")
        # kernel A's checkpoints of noisy frames, and the bytes: with a
        # front pad (offset), off the 24-step grid, and with no tail
        for fb, pad, ckpt, tail in ((768, 0, 24, 6), (96, 12, None, 6),
                                    (64, 0, None, 6), (768, 0, 24, 0)):
            n = fb + tail
            raw = rng.integers(0, 256, (batch, C.RATE * n), dtype=np.int32)
            regs, _ = acs_cuda.forward_regs(
                torch.from_numpy(raw).to(dev), n, ckpt=ckpt, front_pad=pad)
            ck = ckpt or acs_cuda.choose_ckpt(n + pad)
            K = regs.shape[0]
            gap = n + pad - (K - 1) * ck
            what = f"kernel A's registers B={batch} framebits {fb} " \
                   f"front_pad={pad} ckpt={ck} tail={tail}"
            hold_walk(dev, rng, check, regs, ck, gap, what)
            want_rs = tb.tb_walk_plain(regs, ck, gap)
            want = tb._regs_bytes(want_rs, fb, ck, gap, tail, pad)
            for segments in WALK_FORMS:
                rs, got = tb.tb_walk_bytes(regs, fb, ck, gap, tail, pad,
                                           segments=segments)
                check("tb_walk", rs, want_rs,
                      f"{what}, bytes mode, segments={segments} windows")
                check("tb_walk", got, want,
                      f"{what}, bytes mode, segments={segments} bytes")


def walk_times(tag, regs, rs, fused_ms, ck, gap) -> dict:
    """Phase 7, beside kernel B's row on the main-path batch (the row is
    the walk with the bytes in the same launch, as the main path runs it):
    the walk alone, the walk followed by _regs_bytes, and the walk's own
    loads as one independent gather (torch.take on the addresses the walk
    visited: no chain, every load in flight at once), the card's floor for
    them in kernel A's layout. Returns the row's extra keys, every one
    measured here."""
    import torch
    from viterbi_tpu_torch.ops import traceback as tb
    K, _, batch = regs.shape
    segments, _ = tb.segment_layout(K, tb.walk_segments(batch))
    walk_ms, _ = cuda_ms(lambda: tb.tb_walk(regs, ck, gap), 20)
    apart_ms, _ = cuda_ms(
        lambda: tb._regs_bytes(tb.tb_walk(regs, ck, gap), FB_MAIN, ck, gap),
        20)
    # the state in which the walk read checkpoint k: the anchor (0) at
    # K-1, below that the bits above the window of the register read at
    # k+1
    state = torch.zeros_like(rs, dtype=torch.int64)
    state[:-1] = (rs[1:].to(torch.int64) >> ck) & 63
    state[-2] = (rs[-1].to(torch.int64) >> gap) & 63
    k_idx = torch.arange(K, device=rs.device)[:, None]
    b_idx = torch.arange(batch, device=rs.device)[None, :]
    flat = (k_idx * 64 + state) * batch + b_idx
    gather_ms, gathered = cuda_ms(lambda: torch.take(regs, flat), 20)
    assert torch.equal(gathered, rs), "the walk's loads as one gather != rs"
    # not a measurement and not the row's bound: what the 32-byte sectors
    # of the loads and the 4-byte stores would take at the memory rate
    sector_ms = 1e3 * K * batch * 36 / HBM_BYTES_S
    print(f"{tag} tb_walk at B={batch} framebits={FB_MAIN}: {segments} "
          f"segments a frame; with the bytes in the same launch "
          f"{fused_ms:.4f} ms (the row), the walk alone {walk_ms:.4f} ms, "
          f"the walk and _regs_bytes {apart_ms:.4f} ms; its {K * batch} "
          f"loads as one independent gather (torch.take) {gather_ms:.4f} "
          f"ms; their 32-byte sectors and the 4-byte stores at the memory "
          f"rate would take {sector_ms:.4f} ms")
    return {"segments": segments, "walk_ms": walk_ms,
            "walk_then_bytes_ms": apart_ms, "gather_ms": gather_ms}


def rung(name: str) -> None:
    """Select a rung through the config file; raises if it does not hold."""
    from viterbi_tpu_torch.harness import benchmark
    from viterbi_tpu_torch.runtime import dispatch
    benchmark.select_variant(dispatch.VARIANTS.index(name))


def check_words_kernels(rng, dev, check) -> None:
    """Kernels C and D against their plain versions at B_CHECK frames."""
    import torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import traceback as tb
    for fb in WORDS_FRAMEBITS:
        n = fb + C.TAIL_BITS
        raw = rng.integers(0, 256, (B_CHECK, C.RATE * n), dtype=np.int32)
        words = acs_cuda.pack_symbols_host(raw)
        layouts = {False: raw, "bt": words, True: np.ascontiguousarray(
            words.T)}
        for with_init in (False, True):
            init = (torch.from_numpy(rng.integers(0, 256, (B_CHECK, 64))
                                     .astype(np.int32)).to(dev)
                    if with_init else None)
            # the plain version reads every layout as the same unpacked
            # symbols: one plain run serves all three
            d_p, m_p = acs_cuda.forward_plain(
                torch.from_numpy(raw).to(dev), n, init)
            for packed, host in layouts.items():
                dsym = torch.from_numpy(host).to(dev)
                for lanes in FORMS:
                    what = (f"framebits {fb}, packed={packed}, "
                            f"init={with_init}, lanes={lanes}")
                    d_k, m_k = acs_cuda.forward(dsym, n, init, packed=packed,
                                                lanes=lanes)
                    check("acs_words", d_k, d_p, what + " decisions")
                    check("acs_words", m_k, m_p, what + " metrics")
    for fb in WALK_FRAMEBITS:
        n = fb + C.TAIL_BITS
        raw = rng.integers(0, 256, (B_CHECK, C.RATE * n), dtype=np.int32)
        dec, _ = acs_cuda.forward(torch.from_numpy(raw).to(dev), n)
        check("tb_words", tb.tb_words(dec, fb), tb.tb_words_plain(dec, fb),
              f"framebits {fb}")
        # arbitrary words: every bit pattern, the sign bit included
        noise = torch.from_numpy(rng.integers(
            -2**31, 2**31, (n, B_CHECK, 2), dtype=np.int64)
            .astype(np.int32)).to(dev)
        check("tb_words", tb.tb_words(noise, fb),
              tb.tb_words_plain(noise, fb), f"framebits {fb}, random words")


def words_path(syms, packed, out, expect8) -> dict:
    """Phase 5: the cuda_words rung through the public API, then the
    torch_blocked rung; returns the kernels' launch counts on the rung's
    run."""
    import viterbi_tpu_torch
    from viterbi_tpu_torch import golden
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.ops import counts
    rung("cuda_words")
    bits64, syms64 = channel.make_frames(B_CHECK, 64, seed=64)
    counts.zero_launches()
    ret_u, out_u = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, syms)
    t0 = time.perf_counter()
    ret_p, out_p = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, packed,
                                                      packed=True)
    packed_s = time.perf_counter() - t0
    ret_64, out_64 = viterbi_tpu_torch.deconvolve_batch(64, syms64)
    n = counts.launches()
    launches = {k: n[k] for k in ("acs_words", "tb_words")}
    print(f"words path launches: {launches}")
    assert (ret_u, ret_p, ret_64) == (0, 0, 0), (ret_u, ret_p, ret_64)
    for name, count in launches.items():
        assert count > 0, f"the words path never launched {name}"
    assert n["acs_regs"] == n["tb_walk"] == 0, \
        "the words path ran the fused kernels"
    assert np.array_equal(out_u, out), "cuda_words (unpacked) != cuda_fused"
    assert np.array_equal(out_p, out), "cuda_words (packed) != cuda_fused"
    assert np.array_equal(out_u[:8], expect8), "cuda_words != golden"
    assert np.array_equal(out_64, golden.deconvolve_many(64, syms64)), \
        "cuda_words at framebits 64 (blocked fallback) != golden"
    print(f"words path: B={B_MAIN} x {FB_MAIN} unpacked and packed "
          f"bit-equal to cuda_fused and golden (the packed call, its "
          f"first: {packed_s * 1e3:.1f} ms for {packed.nbytes / 1e6:.0f} MB "
          f"of words); framebits 64 (blocked "
          f"fallback) B={B_CHECK}: {channel.ber_fer(out_64, bits64)[2]} "
          f"bit errors, equal to golden")
    rung("torch_blocked")
    t0 = time.perf_counter()
    ret_b, out_b = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, packed,
                                                      packed=True)
    blocked_s = time.perf_counter() - t0
    assert ret_b == 0 and np.array_equal(out_b, out), \
        "torch_blocked != cuda_fused on the main-path batch"
    print(f"torch_blocked bit-equal on the same batch ({blocked_s:.2f} s "
          f"end to end)")
    return launches


def harness_phase(root: Path) -> dict:
    """Phase 6: the test-and-benchmark harness on every rung."""
    from viterbi_tpu_torch.harness import benchmark
    out = root / "build" / "chip_smoke" / "harness.json"
    report = benchmark.main(["/f", str(GATE["frames"]), "/t", "10",
                             "/json", str(out)])
    written = json.loads(out.read_text())
    assert written["chosen_variant"] == report["chosen_variant"]
    variants = written["variants"]
    assert sorted(variants) == sorted(
        ["torch_scan", "torch_blocked", "cuda_words", "cuda_fused"]), \
        f"harness ran {sorted(variants)}"
    for name, rec in variants.items():
        got = (rec["bit_errors"], rec["bad_frames"])
        want = (GATE["bit_errors"], GATE["bad_frames"])
        assert got == want, f"{name}: gate {got} != {want}"
        assert rec.get("device_gsym_s", 0) > 0, f"{name}: no device rate"
    assert written["parity_ok"], "harness parity failure"
    sweep = written["ebno_sweep"]
    assert sweep["ok"], f"Eb/N0 sweep: {sweep}"
    got = {p: v["bit_errors"] for p, v in sweep["points"].items()}
    assert got == SWEEP_ERRORS, f"Eb/N0 sweep {got} != {SWEEP_ERRORS}"
    assert written["fault_injection"] == "PASS", "fault injection failed"
    assert written["ok"]
    return written


def hold_path_kernels(flat, framebits, check, what) -> None:
    """Kernels A and B against their plain versions on the very symbols
    a chain hands acs_cuda.decode: unpacked int32 [N, 4*(framebits+6)],
    decode()'s checkpoint period, no front pad."""
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import traceback as tb
    n, ck = framebits + C.TAIL_BITS, acs_cuda.DECODE_CKPT
    what = f"{what}: {flat.shape[0]} x {framebits} unpacked, ckpt {ck}"
    r_p, m_p = acs_cuda.forward_regs_plain(flat, n, ckpt=ck)
    for lanes in reversed(REGS_FORMS):       # the path's own form last
        r_k, m_k = acs_cuda.forward_regs(flat, n, ckpt=ck, lanes=lanes)
        check("acs_regs", r_k, r_p, f"{what}, lanes={lanes} regs")
        check("acs_regs", m_k, m_p, f"{what}, lanes={lanes} metrics")
    gap = n - (r_k.shape[0] - 1) * ck
    want = tb.tb_walk_plain(r_k, ck, gap)
    check("tb_walk", tb.tb_walk(r_k, ck, gap), want, what + " windows")
    rs, got = tb.tb_walk_bytes(r_k, framebits, ck, gap)
    check("tb_walk", rs, want, what + " windows, bytes mode")
    check("tb_walk", got, tb._regs_bytes(want, framebits, ck, gap),
          what + " bytes")


def superframe_path(dev, tag, check):
    """Phase 8: the DAB+ audio-superframe chain at full width on the
    card; returns kernel A's and B's launch counts on the path, and the
    path's symbols, audio and error counts (phase 17's inputs)."""
    import torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch import golden
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.models import dab
    from viterbi_tpu_torch.ops import counts
    from viterbi_tpu_torch.ops import rs as rs_ops
    from viterbi_tpu_torch.probes import _common, rsform
    cfg = dab.SubchannelConfig(SF_KBPS)
    t0 = time.perf_counter()
    audio, syms = channel.make_superframes(B_SF, SF_KBPS, seed=11,
                                           ebn0_db=EBN0_DB,
                                           uncorrectable=SF_BAD)
    print(f"superframes: {B_SF} x 5 frames of {cfg.framebits} bits, "
          f"{B_SF * cfg.rs_dims} codewords, {syms.nbytes / 1e6:.0f} MB of "
          f"symbols, made in {time.perf_counter() - t0:.1f} s on the host")
    counts.zero_launches()
    got_audio, got_errors = dab.decode_audio_superframes(syms, SF_KBPS)
    torch.cuda.synchronize()
    launches = counts.launches()
    print(f"superframe path launches: {launches}")
    for name in ("acs_regs", "tb_walk", "rs_superframes"):
        assert launches[name] > 0, f"the superframe path never launched {name}"
    # the RS stage is one launch of kernel I's superframes entry
    assert launches["rs_superframes"] == 1 and launches["rs_decode"] == 0, \
        launches
    assert got_audio.is_cuda and got_errors.is_cuda
    assert got_audio.shape == (B_SF, cfg.rs_dims * C.RS_KK)
    assert got_audio.dtype == torch.uint8 and got_errors.shape == (B_SF,)
    out_a, out_e = got_audio.cpu().numpy(), got_errors.cpu().numpy()
    # wherever RS reports success the audio is what was encoded
    sent = audio.transpose(0, 2, 1).reshape(B_SF, -1)
    ok = out_e >= 0
    assert np.array_equal(out_a[ok], sent[ok]), \
        "audio differs from what was encoded where errors >= 0"
    assert (out_e[:SF_BAD] == -1).any(), "no uncorrectable superframe"
    assert ok.sum() >= B_SF - 4 * SF_BAD, f"only {ok.sum()} decoded"
    # the golden model on a subset, the planted failures included
    frames = golden.deconvolve_many(
        cfg.framebits, syms[:SF_GOLDEN].reshape(-1, syms.shape[2]))
    for i, sf in enumerate(frames.reshape(SF_GOLDEN, -1)):
        g_err, g_out = golden.rs_check_superframe(sf, cfg.rs_dims)
        assert out_e[i] == g_err, f"superframe {i}: {out_e[i]} != {g_err}"
        if g_err >= 0:
            assert np.array_equal(out_a[i], g_out), f"superframe {i} audio"
    # the same call on the CPU: plain versions only
    cpu_a, cpu_e = dab.decode_audio_superframes(
        syms[SF_BAD - 2:SF_BAD + SF_PLAIN - 2], SF_KBPS, device="cpu")
    sl = slice(SF_BAD - 2, SF_BAD + SF_PLAIN - 2)
    assert np.array_equal(cpu_e.numpy(), out_e[sl]) and \
        np.array_equal(cpu_a.numpy(), out_a[sl]), "card != CPU plain path"
    print(f"superframe path: {int(ok.sum())} of {B_SF} superframes decoded "
          f"({int((out_e == -1).sum())} uncorrectable, "
          f"{int(out_e[ok].sum())} byte errors corrected by RS); audio equal "
          f"to what was encoded wherever errors >= 0; {SF_GOLDEN} "
          f"superframes equal to golden, {SF_PLAIN} to the CPU's plain path")

    # rates: host array in, host arrays out; then symbols resident
    e2e = []
    for _ in range(3):
        t0 = time.perf_counter()
        a, e = dab.decode_audio_superframes(syms, SF_KBPS)
        a.cpu(), e.cpu()
        e2e.append(time.perf_counter() - t0)
    e2e_s = statistics.median(e2e)
    dsyms = torch.from_numpy(syms).to(dev)
    # the whole batch: each kernel against its plain version on the
    # path's own symbols, and the path's output against the same call
    # through plain versions only (acs.forward, the blocked traceback)
    t0 = time.perf_counter()
    hold_path_kernels(dsyms.reshape(B_SF * dab.SUPERFRAME_FRAMES, -1),
                      cfg.framebits, check, "superframe path")
    # kernel I on the path's own superframes, both entries: the chain's
    # uint8 superframes as they are (and the export's zero fill), and the
    # codewords entry on their [B, rs_dims, 120] view; the probe's table
    # syndrome form on the same superframes
    frame_bytes = dab.decode_frames(
        dsyms.reshape(B_SF * dab.SUPERFRAME_FRAMES, -1), cfg.framebits, True)
    sf_bytes = dab.bytes_to_superframes(
        frame_bytes.reshape(B_SF, dab.SUPERFRAME_FRAMES, cfg.frame_bytes),
        cfg)
    what = (f"superframe path, {B_SF} superframes of {cfg.rs_dims} "
            f"codewords")
    # kernel I's device time a launch inside a replayed CUDA graph (launch
    # to launch, its wrapper's 30-50 us on the host would hide it), and
    # launch to launch as a caller sees it
    def entry(fn):
        return lambda: fn(sf_bytes, cfg.rs_dims, zero_after_fail=False)

    rs_got = entry(rs_ops.rs_check_superframes)()
    rs_ms = _common.graph_ms(entry(rs_ops.rs_check_superframes), 50)
    rs_call_ms = cuda_ms(entry(rs_ops.rs_check_superframes), 20)[0]
    rs_plain_ms, rs_want = cuda_ms(entry(rs_ops.rs_check_superframes_plain),
                                   3)
    table_got = entry(rsform.rs_check_superframes_table_synd)()
    table_ms = _common.graph_ms(
        entry(rsform.rs_check_superframes_table_synd), 50)
    for zero in (False, True):
        want = rs_want if not zero else rs_ops.rs_check_superframes_plain(
            sf_bytes, cfg.rs_dims, zero_after_fail=True)
        got = rs_got if not zero else rs_ops.rs_check_superframes(
            sf_bytes, cfg.rs_dims, zero_after_fail=True)
        table = table_got if not zero else \
            rsform.rs_check_superframes_table_synd(
                sf_bytes, cfg.rs_dims, zero_after_fail=True)
        for g, t, w, part in zip(got, table, want,
                                 ("errors", "audio", "n_ok")):
            check("rs_decode", g, w, f"{what} {part}, zero_after_fail={zero}")
            check("rs_synd_table", t, w,
                  f"{what} {part}, zero_after_fail={zero}")
    assert torch.equal(rs_got[1], got_audio) and \
        torch.equal(rs_got[0], got_errors), "kernel I != the chain's stage"
    blocks = sf_bytes.reshape(B_SF, C.RS_N, cfg.rs_dims).transpose(1, 2)
    cw_got = rs_ops.rs_decode_blocks(blocks)
    cw_ms = _common.graph_ms(lambda: rs_ops.rs_decode_blocks(blocks), 50)
    cw_want = rs_ops.rs_decode_blocks_plain(blocks)
    for g, w, part in zip(cw_got, cw_want, ("count", "corrected")):
        check("rs_decode", g, w, f"{what}, codewords entry on the view "
              f"(strides {tuple(blocks.stride())}) {part}")
    count = cw_got[0].reshape(-1)
    rs_mix = {"superframes": B_SF, "codewords": count.numel(),
              "dirty": int((count != 0).sum()),
              "roots": int(count.clamp(min=0).sum()),
              "uncorrectable": int((count < 0).sum()),
              "ops": rs_decoder_ops(blocks)}
    print(f"superframe path: kernel I (both entries, both syndrome forms) "
          f"bit-identical to its plain version on its {B_SF} superframes "
          f"({rs_mix}); in a replayed graph the superframes entry "
          f"{rs_ms:.4f} ms a launch, with the table syndromes "
          f"{table_ms:.4f} ms, the codewords entry on the view {cw_ms:.4f} "
          f"ms; launch to launch the superframes entry {rs_call_ms:.4f} ms")
    plain_a, plain_e = dab.decode_audio_superframes(dsyms, SF_KBPS,
                                                    use_kernels=False)
    assert torch.equal(plain_a, got_audio) and \
        torch.equal(plain_e, got_errors), \
        "superframe path != the same call through plain versions only"
    del plain_a, plain_e
    torch.cuda.synchronize()
    print(f"superframe path: kernels A and B bit-identical to their plain "
          f"versions on its {B_SF * dab.SUPERFRAME_FRAMES} frames; audio and "
          f"counts of all {B_SF} superframes equal to the plain-only call on "
          f"the card ({time.perf_counter() - t0:.1f} s)")
    res_ms = cuda_ms(lambda: dab.decode_audio_superframes(dsyms, SF_KBPS),
                     5)[0]
    flat = dsyms.reshape(B_SF * dab.SUPERFRAME_FRAMES, -1)
    vit_ms, frame_bytes = cuda_ms(
        lambda: dab.decode_frames(flat, cfg.framebits, True), 5)
    # assembly: the superframes are views of the frame bytes; the RS stage
    # is kernel I's one launch, timed through the chain's own call
    stage_ms, _ = cuda_ms(lambda: dab.rs_superframes(dab.bytes_to_superframes(
        frame_bytes.reshape(B_SF, dab.SUPERFRAME_FRAMES, cfg.frame_bytes),
        cfg), cfg.rs_dims, True), 20)
    counts.zero_launches()
    stage_launches = _common.count_launches(
        lambda: dab.rs_superframes(sf_bytes, cfg.rs_dims, True))
    stage_counts = counts.launches()
    assert stage_counts["rs_superframes"] == 1 and \
        stage_counts["rs_decode"] == 0, stage_counts
    assert stage_launches is not None and stage_launches <= 1, \
        f"the RS stage took {stage_launches} device launches"
    print(f"{tag} superframe path B={B_SF} at {SF_KBPS} kbit/s: "
          f"{B_SF / e2e_s:.1f} superframes/s end to end (median "
          f"{e2e_s * 1e3:.2f} ms of 3), {B_SF / res_ms * 1e3:.1f} "
          f"superframes/s with the symbols resident ({res_ms:.3f} ms); "
          f"split Viterbi {vit_ms:.3f} ms, assembly 0 (views), RS stage "
          f"{stage_ms:.4f} ms launch to launch in {stage_launches} device "
          f"launch (kernel I in a graph {rs_ms:.4f} ms, with the table "
          f"syndromes {table_ms:.4f} ms; the plain version "
          f"{rs_plain_ms:.2f} ms)")
    rs_row = {"ms": rs_ms, "plain_ms": rs_plain_ms, "mix": rs_mix,
              "table_ms": table_ms, "stage_ms": stage_ms}
    return launches, (syms, out_a, out_e), rs_row


def rs_export(tag, check) -> dict:
    """Phase 9a: rs_check_superframe through the API against golden, each
    call's ms and device launches (one kernel and a copy each way), and
    kernel I's superframes entry against its plain version on every case's
    superframe on the card. Returns kernel I's launches a call."""
    import torch
    import viterbi_tpu_torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch import golden
    from viterbi_tpu_torch.ops import counts
    from viterbi_tpu_torch.ops import rs as rs_ops
    from viterbi_tpu_torch.probes import _common
    rung("cuda_fused")
    rng = np.random.default_rng(9)
    per_call = None
    for rs_dims in (1, 4, 16, 48):
        cases = {"clean": [0] * rs_dims,
                 "corrected": [(3 * j) % 6 for j in range(rs_dims)],
                 "uncorrectable": [(j + 1) % 4 if j != rs_dims // 2 else 9
                                   for j in range(rs_dims)]}
        times, k_ms = {}, {}
        for case, errs in cases.items():
            cws = golden.rs_encode_many(rng.integers(
                0, 256, (rs_dims, C.RS_KK), dtype=np.uint8))
            for j, e in enumerate(errs):
                pos = rng.choice(C.RS_N, e, replace=False)
                cws[j, pos] ^= rng.integers(1, 256, e).astype(np.uint8)
            sf = cws.T.reshape(-1)
            g_err, g_out = golden.rs_check_superframe(sf, rs_dims)
            buf = bytearray([0xEE] * (rs_dims * C.RS_KK))

            def call():
                return viterbi_tpu_torch.rs_check_superframe(sf, 0, rs_dims,
                                                             buf)

            runs = []
            counts.zero_launches()
            for _ in range(5):
                buf[:] = bytes([0xEE]) * len(buf)
                t0 = time.perf_counter()
                ret = call()
                runs.append(time.perf_counter() - t0)
            n = counts.launches()
            per_call, rem = divmod(n["rs_superframes"], len(runs))
            assert (per_call, rem) == (1, 0) and n["rs_decode"] == 0, \
                f"kernel I x {n} in {len(runs)} calls"
            times[case] = statistics.median(runs) * 1e3
            assert ret == g_err, f"rs_dims {rs_dims} {case}: {ret} != {g_err}"
            assert (ret == -1) == (case == "uncorrectable")
            want = g_out.copy()
            if ret == -1:
                # golden's out holds the corrected prefix; every other
                # byte of the caller's buffer stays as it was
                n_ok = rs_dims // 2
                want = want.reshape(C.RS_KK, rs_dims)
                want[:, n_ok:] = 0xEE
                want = want.reshape(-1)
            assert np.array_equal(np.frombuffer(bytes(buf), np.uint8),
                                  want), f"rs_dims {rs_dims} {case}: bytes"
            # the entry itself against its plain version, both fills
            dsf = torch.from_numpy(sf).cuda()[None]
            for zero in (True, False):
                got = rs_ops.rs_check_superframes(dsf, rs_dims,
                                                  zero_after_fail=zero)
                want_p = rs_ops.rs_check_superframes_plain(
                    dsf, rs_dims, zero_after_fail=zero)
                for g, w, part in zip(got, want_p, ("errors", "out", "n_ok")):
                    check("rs_decode", g, w, f"export rs_dims {rs_dims} "
                          f"{case} {part}, zero_after_fail={zero}")
            k_ms[case] = _common.graph_ms(lambda: rs_ops.rs_check_superframes(
                dsf, rs_dims, zero_after_fail=True), 100)
        # the corrected case's device operations a call: the copy up,
        # kernel I, the copy back
        n_dev = _common.count_launches(call)
        assert n_dev is not None and n_dev <= 3, \
            f"the export took {n_dev} device operations a call"
        print(f"{tag} rs_check_superframe rs_dims={rs_dims}: clean, "
              f"corrected and -1 (prefix of {rs_dims // 2}) equal to golden "
              f"and kernel I to its plain version; "
              + ", ".join(f"{c} {ms:.4f} ms" for c, ms in times.items())
              + f" a call, {n_dev} device operations (kernel I once); "
              f"the kernel in a replayed graph " + ", ".join(
                  f"{c} {ms:.4f} ms" for c, ms in k_ms.items()))
    return {"rs_superframes": per_call}


#: one-frame deconvolve sizes of phase 9c: the DAB+ ladder and 48 kbit/s
PLAN_SIZES = (192, 768, 1152, 1536, 2304, 3072, 4608, 9216)
PLAN_CALLS = 50


def frame_plan_times(tag) -> dict:
    """Phase 9c: one-frame deconvolve through the API at each size of
    PLAN_SIZES, every call against golden: the first call (eager), the
    second (the plan captured and replayed), then PLAN_CALLS calls on the
    eager path, the size's plan held busy so that the call takes it, and
    PLAN_CALLS replayed, each replay one launch of kernels A and B.
    Returns the median ms a call by size and path, and the plans' counts."""
    import viterbi_tpu_torch
    from viterbi_tpu_torch import golden
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.ops import counts
    from viterbi_tpu_torch.runtime import dispatch, frameplan
    rung("cuda_fused")
    dev = dispatch.state().device
    ms = {}
    for fb in PLAN_SIZES:
        _, syms = channel.make_frames(8, fb, seed=fb)
        syms = syms.astype(np.int32)
        want = golden.deconvolve_many(fb, syms)
        out = np.empty(fb // 8, np.uint8)

        def call(k):
            t0 = time.perf_counter()
            ret = viterbi_tpu_torch.deconvolve(fb, syms[k % 8], 0, out)
            dt = time.perf_counter() - t0
            assert ret == 0 and np.array_equal(out, want[k % 8]), \
                f"deconvolve({fb}) call {k} differs from golden"
            return dt

        call(0)
        call(1)
        plan = frameplan.CACHE.plan(dev, fb)
        assert plan is not None and plan.replays == 1, f"{fb}: no plan"
        with plan.lock:
            eager = [call(k) for k in range(PLAN_CALLS)]
        counts.zero_launches()
        replayed = [call(k) for k in range(PLAN_CALLS)]
        assert counts.only({"acs_regs": PLAN_CALLS, "tb_walk": PLAN_CALLS}), \
            f"{fb}: {counts.launches()} in {PLAN_CALLS} replays"
        ms[fb] = {"eager": statistics.median(eager) * 1e3,
                  "replayed": statistics.median(replayed) * 1e3}
    stats = frameplan.CACHE.stats()
    print(f"{tag} deconvolve of one frame, median ms a call of "
          f"{PLAN_CALLS}, eager / replayed: " + ", ".join(
              f"{fb} bits {t['eager']:.4f} / {t['replayed']:.4f}"
              for fb, t in ms.items())
          + f"; plans {stats['plans']}, captures {stats['captures']}, "
          f"replays {stats['replays']}; every call equal to golden")
    return {"ms": ms, **stats}


def rs_forms(tag) -> dict:
    """Phase 9b: the table form and the bitwise form of the field
    arithmetic and kernel I's codewords entry in its two syndrome forms on
    three error mixes (probes.rsform, which raises unless all four are
    equal, count as planted and agree with golden); kernel I's launches a
    call, counted on every mix; then kernel I's steps (probes.rsphases)."""
    from viterbi_tpu_torch.probes import rsform, rsphases
    rows = rsform.main([])
    assert len(rows) == len(rsform.DECODERS) * len(rsform.MIXES)
    for r in rows:
        assert r["ms"] > 0 and r["launches"], r
        # a kernel form's kernel once a call in its row, none in the
        # field forms' rows
        assert r["kernel_launches"] == (r["form"] in rsform.KERNELS), r
        if r["form"] in rsform.KERNELS:
            assert r["launches"] <= 1, r
    # where kernel I's time goes: its superframes entry with the card's
    # clock at each step (probes.rsphases, equal to the plain version)
    rsphases.main([])
    per_call = {form: {r["kernel_launches"] for r in rows
                       if r["form"] == form} for form in rsform.KERNELS}
    print(f"{tag} RS forms: " + "; ".join(
        f"{r['mix']} {r['form']} {r['ms']:.4f} ms in {r['launches']} launches"
        for r in rows))
    return {"rs_decode": per_call["kernel"].pop(),
            "rs_synd_table": per_call["kernel_table_synd"].pop()}


def eep_path(dev, tag, check):
    """Phase 10: the punctured-frame decoders and the superframe chain fed
    punctured symbols on the card; returns the launches on the path and
    kernel J's times and bytes at EEP 3-A (``punctured_chain``)."""
    import torch
    from viterbi_tpu_torch import golden
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.models import dab
    from viterbi_tpu_torch.models import puncture as P
    from viterbi_tpu_torch.ops import counts
    fb = 24 * SF_KBPS
    launches = {"acs_regs": 0, "tb_walk": 0, "depuncture": 0}
    row = ((24, 24), (40, 16), (20, 9), (12, 5))     # 96 blocks = 128 kbit/s
    profiles = {"EEP 3-A": P.eep_profile(SF_KBPS, 3, "A"),
                "EEP 2-B": P.eep_profile(SF_KBPS, 2, "B"),
                "user row": P.uep_profile_from_row(SF_KBPS, 3, row)}
    for name, prof in profiles.items():
        bits, syms = channel.make_frames(B_CHECK, fb, seed=len(name),
                                         ebn0_db=6.0)
        mask = prof.mask()
        rec = P.puncture(syms, mask).astype(np.int32)

        def decode(received, **kw):
            if name == "EEP 3-A":
                return dab.decode_punctured_frames(received, SF_KBPS, 3, "A",
                                                   **kw)
            if name == "EEP 2-B":
                return dab.decode_punctured_frames(received, SF_KBPS, 2, "B",
                                                   **kw)
            return dab.decode_profile_frames(received, prof, **kw)

        counts.zero_launches()
        t0 = time.perf_counter()
        got = decode(rec)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = counts.launches()
        for k in launches:
            launches[k] += n[k]
        assert got.is_cuda and got.shape == (B_CHECK, fb // 8)
        out = got.cpu().numpy()
        want = golden.deconvolve_many(fb, P.depuncture(rec[:4], mask))
        assert np.array_equal(out[:4], want), f"{name} != golden"
        # the whole batch through plain versions only (acs.forward, the
        # serial traceback) on the card, and each kernel against its plain
        # version on the depunctured symbols
        drec = torch.from_numpy(rec).to(dev)
        assert torch.equal(decode(drec, use_kernels=False), got), \
            f"{name} != the same call through plain versions only"
        hold_path_kernels(dab.depuncture_device(drec, mask), fb, check, name)
        print(f"{tag} {name} at {SF_KBPS} kbit/s: B={B_CHECK}, "
              f"{prof.transmitted_bits} of {mask.size} symbols sent, "
              f"{channel.ber_fer(out, bits)[2]} bit errors at 6 dB, equal "
              f"to golden on 4 frames and to the plain-only call on all; "
              f"kernels J, A and B once; A and B bit-identical to plain on "
              f"its symbols "
              f"({ms:.1f} ms end to end)")
    for name, count in launches.items():
        assert count == len(profiles), f"EEP path: {name} x {count}"
    chain = punctured_chain(dev, tag, check)
    for name, count in chain.pop("launches").items():
        launches[name] = launches.get(name, 0) + count
    return launches, chain


def punctured_chain(dev, tag, check) -> dict:
    """Phase 10, second part: decode_audio_superframes with ``protection``
    once per EEP-A level at SF_KBPS on EEP_SF staged superframes (two of
    them uncorrectable): one launch each of kernels J, A, B and I, equal
    to the plain-only call on the card and to the plain reference on two
    superframes; kernel J against its plain version on the path's bytes,
    timed at EEP 3-A."""
    import torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.models import dab
    from viterbi_tpu_torch.models import puncture as P
    from viterbi_tpu_torch.ops import counts
    from viterbi_tpu_torch.ops import depuncture as dp
    from viterbi_tpu_torch.probes import _common
    from viterbi_tpu_torch.reference import punctured as R
    kernels = ("depuncture", "acs_regs", "tb_walk", "rs_superframes")
    launches = dict.fromkeys(kernels, 0)
    timed = {}
    for level in (1, 2, 3, 4):
        protection = ("A", level)
        prof = dab.protection_profile(protection, SF_KBPS)
        kept = prof.transmitted_bits
        # Es/N0 3 dB on every symbol (the mother code's Eb/N0 9 dB)
        _, syms = channel.make_superframes(EEP_SF, SF_KBPS, seed=level,
                                           ebn0_db=9.0, uncorrectable=2)
        rec = P.puncture(syms, prof.mask()).astype(np.int32)
        del syms
        counts.zero_launches()
        t0 = time.perf_counter()
        audio, errors = dab.decode_audio_superframes(rec, SF_KBPS,
                                                     protection=protection)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = counts.launches()
        assert all(n[k] == 1 for k in kernels), f"EEP {level}-A chain: {n}"
        for k in kernels:
            launches[k] += n[k]
        drec = torch.from_numpy(rec).to(dev)
        p_audio, p_errors = dab.decode_audio_superframes(
            drec, SF_KBPS, use_kernels=False, protection=protection)
        assert torch.equal(audio, p_audio) and \
            torch.equal(errors, p_errors), \
            f"EEP {level}-A chain != the plain-only call"
        # superframe 1 uncorrectable, superframe 2 not
        r_audio, r_errors = R.decode_superframes(rec[1:3], SF_KBPS,
                                                 protection)
        assert torch.equal(audio[1:3].cpu(), r_audio) and \
            torch.equal(errors[1:3].cpu(), r_errors), \
            f"EEP {level}-A chain != the plain reference"
        errs = errors.cpu()
        assert (errs == -1).sum() >= 2, errs
        # the bytes as the staged ingest hands them over: contiguous rows
        # (puncturing on the host leaves ``rec`` column-major, and the
        # wrapper would time a transposing copy with the kernel)
        flat = drec.reshape(-1, kept).to(torch.uint8).contiguous()
        got, want = dp.depuncture(flat, prof), dp.depuncture_plain(flat,
                                                                   prof)
        check("depuncture", got, want, f"EEP {level}-A at {SF_KBPS} kbit/s, "
              f"{flat.shape[0]} frames of {kept} bytes")
        if level == 3:
            # the kernel's device time inside a replayed CUDA graph (launch
            # to launch, its wrapper's host time would hide it), and
            # launch to launch as the chain calls it
            k_ms = _common.graph_ms(lambda: dp.depuncture(flat, prof), 50)
            call_ms, _ = cuda_ms(lambda: dp.depuncture(flat, prof), 50)
            p_ms, _ = cuda_ms(lambda: dp.depuncture_plain(flat, prof), 5)
            timed = {"ms": k_ms, "plain_ms": p_ms, "frames": flat.shape[0],
                     "bytes": flat.numel() + got.numel(),
                     "steps": flat.shape[0] * got.shape[1] // C.RATE}
            print(f"{tag} kernel J at EEP 3-A, {flat.shape[0]} frames of "
                  f"{kept} bytes: {k_ms:.4f} ms in a replayed graph, "
                  f"{call_ms:.4f} ms launch to launch, plain {p_ms:.3f} ms, "
                  f"bit-identical")
        del drec, flat, got, want
        print(f"{tag} chain EEP {level}-A at {SF_KBPS} kbit/s: B={EEP_SF} "
              f"superframes of {kept} symbols a frame ({rec.nbytes / 1e6:.1f}"
              f" MB int32, staged), {int((errs > 0).sum())} corrected, "
              f"{int((errs == -1).sum())} uncorrectable; kernels J, A, B, I "
              f"once each, equal to the plain-only call and the reference "
              f"({ms:.1f} ms end to end)")
    return {"launches": launches, **timed}


def rs_packet_mix(n: int, seed: int) -> np.ndarray:
    """``n`` RS(204,188) codewords uint8[n, 204] of random messages, each
    hit by TS_MIX's byte errors at random places: clean, 1 to 8 (every
    branch of the dirty path) and 12 (mostly uncorrectable)."""
    from viterbi_tpu_torch.reference import tdmb as R
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (256, R.K), dtype=np.uint8)
    cws = np.stack([R.rs_encode(m) for m in msgs])[rng.integers(0, 256, n)]
    errs = rng.choice(list(TS_MIX), n, p=list(TS_MIX.values()))
    hit = np.zeros((n, R.N), dtype=bool)
    np.put_along_axis(hit, np.argsort(rng.random((n, R.N)), axis=1),
                      np.arange(R.N)[None, :] < errs[:, None], axis=1)
    values = rng.integers(1, 256, (n, R.N), dtype=np.uint8)
    return cws ^ np.where(hit, values, 0).astype(np.uint8)


def tdmb_kernels(dev, tag, check, clock_hz) -> tuple:
    """Phase 3, T-DMB: kernel K and kernel I's RS(204,188) entry against
    their plain versions at the shapes of a chain call of
    ``tdmb_stream.bulk`` (TS_GROUPS: streams x TS_CALL_CIFS CIFs x
    packets a CIF), K fresh and then continuing its own carry, I on
    TS_MIX's clean, dirty and 12-error codewords, contiguous and through
    rows 256 bytes apart; one launch a call each. Returns their times
    (device time in a replayed graph, plain on the card) and bounds at
    the 544 kbit/s group's call."""
    import torch
    from viterbi_tpu_torch.ops import counts
    from viterbi_tpu_torch.ops import deinterleave as dl
    from viterbi_tpu_torch.ops import rs as rs_ops
    from viterbi_tpu_torch.probes import _common
    g = torch.Generator(device=dev).manual_seed(25)
    times, bounds = {}, {}
    for S, p in TS_GROUPS:
        L = TS_CALL_CIFS * p * dl.PACKET
        carry = carry_p = None
        for part in ("fresh", "continued"):
            data = torch.randint(0, 256, (S, L), generator=g, device=dev,
                                 dtype=torch.uint8)
            counts.zero_launches()
            out, new = dl.deinterleave(data, carry)
            torch.cuda.synchronize()
            assert counts.only({"deinterleave": 1}), counts.launches()
            want, want_new = dl.deinterleave_plain(data.cpu(), carry_p)
            what = f"{S} streams x {L} bytes, {part}"
            check("deinterleave", out, want, what + ", codewords")
            check("deinterleave", new, want_new, what + ", carry")
            if (S, p) == TS_GROUPS[0] and part == "continued":
                cont = carry
                times["deinterleave"] = (
                    _common.graph_ms(lambda: dl.deinterleave(data, cont),
                                     100),
                    cuda_ms(lambda: dl.deinterleave_plain(data, cont),
                            5)[0])
                bounds["deinterleave"] = bound(2 * S * L + 2 * S
                                               * dl.CARRY_BYTES, 0.0,
                                               clock_hz)
            carry, carry_p = new, want_new
    n = TS_GROUPS[0][0] * TS_CALL_CIFS * TS_GROUPS[0][1]
    rx = torch.from_numpy(rs_packet_mix(n, seed=25))
    want_count, want_data = rs_ops.rs_decode_packets_plain(rx)
    wide = torch.zeros((n, 256), dtype=torch.uint8)
    wide[:, 20:20 + rs_ops.P_N] = rx
    drx, dwide = rx.to(dev), wide.to(dev)[:, 20:20 + rs_ops.P_N]
    for what, x in (("contiguous", drx), ("rows 256 B apart", dwide)):
        counts.zero_launches()
        count, data = rs_ops.rs_decode_packets(x)
        torch.cuda.synchronize()
        assert counts.only({"rs_packets": 1}), counts.launches()
        check("rs_packets", count, want_count, f"{n} codewords {what}")
        check("rs_packets", data, want_data, f"{n} codewords {what}")
    mix = {"clean": int((want_count == 0).sum()),
           "corrected": int((want_count > 0).sum()),
           "failed": int((want_count == -1).sum())}
    assert all(mix.values()), mix
    times["rs_packets"] = (
        _common.graph_ms(lambda: rs_ops.rs_decode_packets(drx), 100),
        cuda_ms(lambda: rs_ops.rs_decode_packets_plain(drx), 2)[0])
    # bytes in and out, the syndromes' 1632 x 128 product on the tensor
    # cores; the dirty codewords' work left out (dabbench/roofline_tdmb)
    bounds["rs_packets"] = bound(
        n * (rs_ops.P_N + rs_ops.P_K + 4), 0.0, clock_hz,
        tensor_ops=n * 2 * (8 * rs_ops.P_N) * (8 * rs_ops.P_NROOTS))
    print(f"{tag} kernel K vs plain: {TS_GROUPS} (streams, packets a CIF) "
          f"x {TS_CALL_CIFS} CIFs, fresh and continued, bit-identical, "
          f"{times['deinterleave'][0]:.4f} ms a call in a replayed graph; "
          f"kernel I's RS(204,188) entry vs plain: {n} codewords {mix}, "
          f"contiguous and strided, bit-identical, "
          f"{times['rs_packets'][0]:.4f} ms in a replayed graph")
    return times, bounds


def tdmb_path(dev, tag) -> dict:
    """Phase 10, T-DMB: ``models.tdmb.decode_ts_streams`` on TS_STREAMS
    streams at 544 kbit/s EEP-3A over TS_CIFS CIFs (above the eleven
    packets of zero fill) in two calls, the second continuing the first's
    state: one launch each of kernels J, A, B, K and I's packets entry a
    call, equal to the same calls through plain versions only on the
    card; returns the launches."""
    import torch
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.models import tdmb
    from viterbi_tpu_torch.ops import counts
    kernels = ("depuncture", "acs_regs", "tb_walk", "deinterleave",
               "rs_packets")
    rx = torch.from_numpy(channel.make_ts_streams(
        TS_STREAMS, TS_CIFS, 544, seed=25, esn0_db=-0.2, bad=(13,))).to(dev)
    half = TS_CIFS // 2
    counts.zero_launches()
    t0 = time.perf_counter()
    a = tdmb.decode_ts_streams(rx[:, :half], 544)
    b = tdmb.decode_ts_streams(rx[:, half:], 544, state=a[2])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = counts.launches()
    assert counts.only(dict.fromkeys(kernels, 2)), launches
    pa = tdmb.decode_ts_streams(rx[:, :half], 544, use_kernels=False)
    pb = tdmb.decode_ts_streams(rx[:, half:], 544, state=pa[2],
                                use_kernels=False)
    for got, want in ((a, pa), (b, pb)):
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            "the T-DMB chain != the same calls through plain versions only"
    errors = torch.cat([a[1], b[1]], 1).cpu()
    assert (errors == -1).any() and (errors > 0).any(), errors
    print(f"{tag} T-DMB chain at 544 kbit/s: {TS_STREAMS} streams x "
          f"{TS_CIFS} CIFs in two calls with the carry, "
          f"{int((errors > 0).sum())} packets corrected, "
          f"{int((errors == -1).sum())} uncorrectable; kernels J, A, B, K, "
          f"I once a call, equal to the plain-only calls ({ms:.1f} ms)")
    return launches


def replay_phase(root: Path) -> None:
    """Phase 11: the committed capture corpus through the port's API."""
    from viterbi_tpu_torch.harness import replay
    rung("cuda_fused")
    n_ok, n_total, report = replay.replay_corpus(
        str(root / "tests" / "data" / "corpus"))
    bad = [r for r in report if not r[2]]
    assert n_total == 13 and n_ok == n_total and not bad, bad
    kinds = sorted({r[1] for r in report})
    print(f"replay: {n_ok} of {n_total} corpus captures ok ({kinds})")


def probes_phase(dev, tag, check, clock_hz) -> dict:
    """Phase 12: kernels E to H against their plain versions at the
    probes' own shapes, then each probe's table. Returns the kernels'
    rows for the JSON line (without name and route)."""
    import torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.probes import kablate, kdtype, kilp
    rng = np.random.default_rng(12)
    rows = {}
    ck = acs_cuda.DECODE_CKPT

    def words(batch, n):
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, (batch, n), dtype=np.int64).astype(np.int32)) \
            .to(dev)

    # --- E: every variant at B_CHECK over a few sizes, then at the probe's
    # shape; full against kernel A
    t0 = time.perf_counter()
    for fb in (3072, 768, 64, 32):
        n = fb + C.TAIL_BITS
        w = words(B_CHECK, n)
        for name, abl in kablate.VARIANTS:
            r_p, m_p = kablate.forward_regs_ablated_plain(w, n, abl, ck)
            for lanes in FORMS:
                r_k, m_k = kablate.forward_regs_ablated(w, n, abl, ck,
                                                        lanes=lanes)
                what = f"{name} framebits {fb}, lanes={lanes}"
                check("kablate", r_k, r_p, what + " regs")
                check("kablate", m_k, m_p, what + " metrics")
    n = FB_MAIN + C.TAIL_BITS
    w = words(E_BATCH, n)
    for name, abl in kablate.VARIANTS:
        k_ms, (r_k, m_k) = cuda_ms(
            lambda: kablate.forward_regs_ablated(w, n, abl, ck), 5)
        p_ms, (r_p, m_p) = cuda_ms(
            lambda: kablate.forward_regs_ablated_plain(w, n, abl, ck), 1)
        check("kablate", r_k, r_p, f"{name} B={E_BATCH} regs")
        check("kablate", m_k, m_p, f"{name} B={E_BATCH} metrics")
        r_1, m_1 = kablate.forward_regs_ablated(w, n, abl, ck, lanes=1)
        check("kablate", r_1, r_p, f"{name} B={E_BATCH}, one lane, regs")
        check("kablate", m_1, m_p, f"{name} B={E_BATCH}, one lane, metrics")
        if not abl:
            r_a, m_a = acs_cuda.forward_regs(w, n, ckpt=ck, packed="bt")
            check("kablate", r_k, r_a, "full against kernel A, regs")
            check("kablate", m_k, m_a, "full against kernel A, metrics")
            K = r_k.shape[0]
            rows["kablate"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=None,
                **bound(E_BATCH * (n * 4 + 256 + K * 256 + 256),
                        E_BATCH * n * OPS_PER_STEP_A, clock_hz))
    del w, r_k, m_k, r_p, m_p, r_a, m_a, r_1, m_1
    print(f"kernel E vs plain: {len(kablate.VARIANTS)} variants x "
          f"(4 sizes at B={B_CHECK}, B={E_BATCH} x {FB_MAIN}) in both forms "
          f"bit-identical, full equal to kernel A "
          f"({time.perf_counter() - t0:.1f} s)")

    # --- F: every (type, op) on the probe's shape
    t0 = time.perf_counter()
    for dtype, op in [(d, o) for d in kdtype.OP_DTYPES for o in kdtype.OPS] \
            + list(kdtype.PACKED_OPS):
        lane = kdtype._lane_dtype(dtype)
        bits = kdtype._BITS[lane]
        lo = -(1 << (bits - 1)) if lane.startswith("i") else 0
        x, y = (torch.from_numpy(rng.integers(
            lo, lo + (1 << bits), kdtype.OP_SHAPE).astype(np.int32)).to(dev)
            for _ in range(2))
        check("kdtype_op", kdtype.elementwise(op, dtype, x, y),
              kdtype.elementwise_plain(op, dtype, x, y), f"{dtype} {op}")
        # around one thread's 16 bytes, with and without a tail, and on
        # views that start one element past a 16-byte boundary
        per = kdtype._PACKED[dtype][1] if dtype in kdtype._PACKED else 1
        codes = kdtype._op_codes(op, dtype)
        for count in kdtype.TAIL_COUNTS:
            for skip in (0, 1):
                x, y = (torch.from_numpy(rng.integers(
                    lo, lo + (1 << bits), (count + skip) * per)
                    .astype(np.int32)).to(dev) for _ in range(2))
                a = kdtype._to_storage(x, dtype)[skip:]
                b = kdtype._to_storage(y, dtype)[skip:]
                out = torch.empty(count + skip, dtype=a.dtype,
                                  device=dev)[skip:]
                assert (a.data_ptr() % 16 != 0) == bool(skip)
                kdtype._launch_op(codes, a, b, out)
                check("kdtype_op",
                      kdtype._from_storage(out, dtype, (count * per,)),
                      kdtype.elementwise_plain(op, dtype, x[skip * per:],
                                               y[skip * per:]),
                      f"{dtype} {op}, {count} stored elements, "
                      f"{'not ' if skip else ''}aligned")
    # the row: u8 add, beside the one PyTorch call that computes it
    x, y = (torch.from_numpy(rng.integers(0, 256, kdtype.OP_SHAPE)
                             .astype(np.int32)).to(dev) for _ in range(2))
    a8, b8 = x.to(torch.uint8), y.to(torch.uint8)
    out8 = torch.empty_like(a8)
    codes = kdtype._op_codes("add", "u8")
    nlanes = x.numel()
    # ms: the launch alone on operands stored as u8, as the library call
    # has them, launch to launch (what the host can enqueue); bare_ms: the
    # bound C function with its arguments converted once; graph_ms and
    # library_graph_ms: the device's own time a launch, inside a replayed
    # CUDA graph of 1000; wrapper_ms: with the wrapper's conversions from
    # and to int32 lane values
    from viterbi_tpu_torch.ops import _build
    from viterbi_tpu_torch.probes import _common
    bare = _build.KDTYPE_OP.function()
    bare_args = (*codes, a8.data_ptr(), b8.data_ptr(), out8.data_ptr(),
                 nlanes, torch.cuda.current_stream(dev).cuda_stream)

    def bare_launch():
        assert bare(*bare_args) == 0

    rows["kdtype_op"] = dict(
        ms=cuda_ms(lambda: kdtype._launch_op(codes, a8, b8, out8), 2000)[0],
        bare_ms=cuda_ms(bare_launch, 2000)[0],
        graph_ms=_common.graph_ms(
            lambda: kdtype._launch_op(codes, a8, b8, out8)),
        wrapper_ms=cuda_ms(
            lambda: kdtype.elementwise("add", "u8", x, y), 50)[0],
        plain_ms=cuda_ms(
            lambda: kdtype.elementwise_plain("add", "u8", x, y), 50)[0],
        library_ms=cuda_ms(lambda: torch.add(a8, b8), 2000)[0],
        library_graph_ms=_common.graph_ms(
            lambda: torch.add(a8, b8, out=out8)),
        **bound(3 * nlanes, nlanes, clock_hz))
    check("kdtype_op", out8, torch.add(a8, b8), "u8 add on stored operands")
    r = rows["kdtype_op"]
    print(f"{tag} launch path, u8 add on {kdtype.OP_SHAPE}, ms a launch: "
          f"torch.add {r['library_ms']:.5f}, kernel F through its wrapper's "
          f"launch {r['ms']:.5f}, the bare C call {r['bare_ms']:.5f}, inside "
          f"a replayed graph of 1000 kernel F {r['graph_ms']:.5f}, torch.add "
          f"{r['library_graph_ms']:.5f}")
    print(f"kernel F vs plain: {len(kdtype.OP_DTYPES) * len(kdtype.OPS)} "
          f"narrow and {len(kdtype.PACKED_OPS)} packed ops on "
          f"{kdtype.OP_SHAPE} and at {kdtype.TAIL_COUNTS} stored elements, "
          f"aligned and not, bit-identical "
          f"({time.perf_counter() - t0:.1f} s)")

    # --- G: every type at the probe's shape and rounds
    t0 = time.perf_counter()
    x = torch.from_numpy(rng.integers(0, 204, kdtype.CHAIN_SHAPE)
                         .astype(np.int32)).to(dev)
    p_ms, want = cuda_ms(
        lambda: kdtype.chain_plain(x, kdtype.CHAIN_ROUNDS, "i32"), 1)
    for dtype in kdtype.CHAIN_DTYPES:
        k_ms, got = cuda_ms(
            lambda: kdtype.chain(x, kdtype.CHAIN_ROUNDS, dtype), 3)
        check("kdtype_chain", got, want, f"{dtype}")
        if dtype == "i32":
            rows["kdtype_chain"] = dict(
                ms=k_ms, plain_ms=p_ms, library_ms=None,
                **bound(8 * x.numel(), OPS_PER_ROUND_G * x.numel()
                        * kdtype.CHAIN_ROUNDS, clock_hz))
    wide = torch.from_numpy(rng.integers(0, 256, (64, 256))
                            .astype(np.int32)).to(dev)
    for dtype in kdtype.CHAIN_DTYPES[1:]:       # lanes that wrap in 8 bits
        check("kdtype_chain", kdtype.chain(wide, 41, dtype),
              kdtype.chain_plain(wide, 41, dtype), f"{dtype} wrapping")
    print(f"kernel G vs plain: {len(kdtype.CHAIN_DTYPES)} types x "
          f"{kdtype.CHAIN_ROUNDS} rounds on {kdtype.CHAIN_SHAPE} "
          f"bit-identical ({time.perf_counter() - t0:.1f} s)")

    # --- H: every mode and stream count at the probe's shape and rounds
    t0 = time.perf_counter()
    x = torch.from_numpy(rng.integers(-999, 999, kilp.SHAPE)
                         .astype(np.int32)).to(dev)
    for mode in kilp.MODES:
        for ns in kilp.STREAMS:
            k_ms, got = cuda_ms(
                lambda: kilp.streams(x, ns, mode, kilp.ROUNDS), 3)
            p_ms, want = cuda_ms(
                lambda: kilp.streams_plain(x, ns, mode, kilp.ROUNDS), 1)
            check("kilp_streams", got, want, f"{mode} streams={ns}")
            check("kilp_streams", kilp.streams(x, ns, mode, 25, -2),
                  kilp.streams_plain(x, ns, mode, 25, -2),
                  f"{mode} streams={ns} c=-2")
            if (mode, ns) == ("int", 8):
                ops = x.numel() * kilp.ROUNDS * ns * OPS_PER_ROUND_H
                rows["kilp_streams"] = dict(
                    ms=k_ms, plain_ms=p_ms, library_ms=None,
                    **bound(8 * x.numel(), ops, clock_hz))
    print(f"kernel H vs plain: {len(kilp.MODES)} modes x {kilp.STREAMS} "
          f"streams x {kilp.ROUNDS} rounds on {kilp.SHAPE} bit-identical "
          f"({time.perf_counter() - t0:.1f} s)")

    # --- the probes' own entry points: their tables, launches counted
    counters = {k.name: k for k in (_build.KABLATE, _build.KDTYPE_OP,
                                    _build.KDTYPE_CHAIN, _build.KILP_STREAMS)}
    for kernel in counters.values():
        kernel.zero()
    t0 = time.perf_counter()
    abl_ms = kablate.main(["--iters", "10"])
    abl_one_ms = kablate.main(["--iters", "10", "--lanes", "1"])
    dt = kdtype.main([])
    ilp = kilp.main([])
    for name, kernel in counters.items():
        assert kernel.launches > 0, f"the probes never launched {name}"
        rows[name]["launches"] = kernel.launches
    assert all(r["right"] for r in dt["ops"] + dt["chain"]), \
        "a kdtype row is wrong"
    # the loops are there: half the rounds take clearly less time (where
    # a run is long enough to stand clear of a launch's own cost)
    timed_rows = [r for r in dt["chain"] + ilp if r["ms"] > 0.06]
    assert len(timed_rows) > len(ilp) // 2, "the probes' runs are too short"
    for r in timed_rows:
        assert r["half_rounds_ms"] < 0.8 * r["ms"], f"no loop in {r}"
    for table in (abl_ms, abl_one_ms):
        assert abs(table["full"] - table["kernel A"]) \
            < 0.1 * table["kernel A"], "full is not kernel A's time"
    print(f"{tag} probes' tables: {time.perf_counter() - t0:.1f} s")
    return rows


# --- phases 13-16: beyond one frame ----------------------------------------


def parts_text(parts: dict) -> str:
    """Device ms of a call's parts, each timed alone."""
    return ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + " ms alone"


def tailbiting_phase(dev, tag, check) -> dict:
    """Phase 13: tail-biting frames through ops.tailbiting; returns the
    kernels' launches on the main tail-biting call."""
    import torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch import golden
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.ops import acs_cuda, tailbiting
    from viterbi_tpu_torch.ops import traceback as tb
    from viterbi_tpu_torch.tools import _record
    fb, wrap = FB_MAIN, TB_WRAP
    gen = torch.Generator(device=dev).manual_seed(13)
    bits = torch.randint(0, 2, (TB_FRAMES, fb), generator=gen, device=dev)
    syms = channel.soft_on_device(bits, True, gen)
    two = bits[:2].cpu().numpy().astype(np.uint8)
    hard = channel.hard_on_device(bits[:2], True).cpu().numpy()
    assert all(np.array_equal(hard[i], golden.encode_tailbiting(two[i]))
               for i in range(2)), "the card's tail-biting encoder"
    assert np.array_equal(channel.hard_on_device(bits[:2], False).cpu()
                          .numpy(),
                          channel.encode_batch(two)), "the card's encoder"
    _record.zero_launches()
    out = tailbiting.decode_tailbiting(syms, fb, wrap)
    torch.cuda.synchronize()
    launches = _record.launches()
    print(f"tail-biting launches: {launches}")
    assert _record.only({"acs_regs": 1, "acs_words": 1, "tb_walk": 1},
                        launches), launches
    assert out.device == syms.device and out.shape == (TB_FRAMES, fb // 8)
    nerr = channel.bit_errors_on_device(out, bits)
    assert nerr < TB_FRAMES * fb * 1e-3, f"{nerr} bit errors at 3 dB"
    t0 = time.perf_counter()
    plain = tailbiting.decode_tailbiting(syms, fb, wrap, use_kernels=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    assert torch.equal(out, plain), "tail-biting kernels != plain on the card"
    host = syms[:TB_GOLDEN].cpu().numpy()
    want = np.stack([golden.tailbiting_decode(fb, s, wrap) for s in host])
    assert np.array_equal(out[:TB_GOLDEN].cpu().numpy(), want), \
        "tail-biting != golden"
    # each kernel against its plain version on the path's own inputs
    zero = torch.zeros((TB_FRAMES, 64), dtype=torch.int32, device=dev)
    warm = syms[:, 4 * (fb - wrap):]
    d_k, m_k = acs_cuda.forward(warm, wrap, zero)
    d_p, m_p = acs_cuda.forward_plain(warm, wrap, zero)
    check("acs_words", d_k, d_p, "tail-biting warm-up decisions")
    check("acs_words", m_k, m_p, "tail-biting warm-up metrics")
    ckpt = acs_cuda.choose_ckpt(fb)
    r_k, f_k = acs_cuda.forward_regs(syms, fb, m_k, ckpt=ckpt)
    r_p, f_p = acs_cuda.forward_regs_plain(syms, fb, m_k, ckpt=ckpt)
    check("acs_regs", r_k, r_p, "tail-biting pass registers")
    check("acs_regs", f_k, f_p, "tail-biting pass metrics")
    del r_p, d_k, d_p
    anchor = torch.argmin(f_k, dim=1).to(torch.int32)
    gap = fb - (r_k.shape[0] - 1) * ckpt
    rs_k, bytes_k = tb.tb_walk_bytes(r_k, fb, ckpt, gap, tail=0,
                                     anchor=anchor)
    rs_p = tb.tb_walk_plain(r_k, ckpt, gap, anchor)
    check("tb_walk", rs_k, rs_p, "tail-biting walk windows")
    check("tb_walk", bytes_k, tb._regs_bytes(rs_p, fb, ckpt, gap, 0),
          "tail-biting walk bytes")
    parts = {"C": cuda_ms(lambda: acs_cuda.forward(warm, wrap, zero), 5)[0],
             "A": cuda_ms(lambda: acs_cuda.forward_regs(
                 syms, fb, m_k, ckpt=ckpt), 5)[0],
             "B": cuda_ms(lambda: tb.tb_walk_bytes(
                 r_k, fb, ckpt, gap, tail=0, anchor=anchor), 5)[0]}
    del r_k
    # forced end-metric ties: argmin takes the lowest state on the card
    ties = 127 + torch.randint(0, 2, (B_CHECK, 4 * 768), generator=gen,
                               device=dev, dtype=torch.int32)
    _, m = acs_cuda.forward(ties[:, 4 * (768 - wrap):], wrap,
                            torch.zeros_like(zero[:1]).expand(B_CHECK, -1))
    _, m = acs_cuda.forward(ties, 768, m)
    tied = int(((m == m.min(dim=1, keepdim=True).values).sum(dim=1) > 1)
               .sum())
    assert tied > B_CHECK // 4, f"only {tied} frames with tied end metrics"
    assert np.array_equal(torch.argmin(m, dim=1).cpu().numpy(),
                          np.argmin(m.cpu().numpy(), axis=1)), \
        "argmin on the card does not take the lowest index on ties"
    t_out = tailbiting.decode_tailbiting(ties, 768, wrap)
    assert torch.equal(t_out, tailbiting.decode_tailbiting(
        ties, 768, wrap, use_kernels=False)), "ties: kernels != plain"
    host = ties[:4].cpu().numpy()
    assert np.array_equal(t_out[:4].cpu().numpy(), np.stack(
        [golden.tailbiting_decode(768, s, wrap) for s in host])), \
        "ties != golden"
    fx = np.load(ROOT / "tests" / "data" / "tb_tie_syms.npy")[None]
    assert np.array_equal(
        tailbiting.decode_tailbiting(fx, 768, 96).cpu().numpy()[0],
        golden.tailbiting_decode(768, fx[0], 96)), "tie fixture != golden"
    # the edges of the frame sizes
    for sfb, swrap, batch in ((8, 8, B_CHECK), (32, 32, B_CHECK),
                              (9216, 96, 64)):
        sbits = torch.randint(0, 2, (batch, sfb), generator=gen, device=dev)
        s = channel.soft_on_device(sbits, True, gen)
        got = tailbiting.decode_tailbiting(s, sfb, swrap)
        host = s[:2].cpu().numpy()
        assert np.array_equal(got[:2].cpu().numpy(), np.stack(
            [golden.tailbiting_decode(sfb, x, swrap) for x in host])), \
            f"framebits {sfb} != golden"
        if sfb < 100:
            assert torch.equal(got, tailbiting.decode_tailbiting(
                s, sfb, swrap, use_kernels=False)), f"framebits {sfb}"
    k_ms, _ = cuda_ms(lambda: tailbiting.decode_tailbiting(syms, fb, wrap), 5)
    nsym = TB_FRAMES * C.RATE * fb
    print(f"{tag} tail-biting B={TB_FRAMES} framebits={fb} wrap {wrap} at "
          f"{EBN0_DB} dB: {nerr} bit errors; kernels C + A + B {k_ms:.3f} "
          f"ms resident ({nsym / k_ms / 1e6:.1f} Gsym/s; {parts_text(parts)}"
          f"), the plain path "
          f"on the card {plain_s:.2f} s, bit-equal; {TB_GOLDEN} frames, "
          f"the tie fixture, {tied} frames with tied end metrics and "
          f"framebits 8, 32, 9216 equal to golden")
    return launches


def streaming_phase(dev, tag, check, fused_gsym) -> dict:
    """Phase 14: one-card block-overlap streaming (``tools.stream.cell``)
    at the shapes of STREAM_TPU.json; returns the launches of the first
    cell's call."""
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import traceback as tb
    from viterbi_tpu_torch.tools import stream
    first = None
    for streams, n_blocks, blk in STREAM_CELLS:
        sb = n_blocks * blk

        def hold(fwd, walk):
            """Kernels A and B against their plain versions on the call's
            own inputs; kernel B in every form, anchored below the top."""
            for args, kw, (regs, metrics) in fwd:
                r_p, m_p = acs_cuda.forward_regs_plain(*args, **kw)
                check("acs_regs", regs, r_p, f"streaming {streams} x {sb}")
                check("acs_regs", metrics, m_p,
                      f"streaming {streams} x {sb}")
            (regs, k, state, emit, ckpt), _, got = walk[0]
            assert bool((k < regs.shape[0] - 1).any()), "no interior anchor"
            want_rs = tb.tb_walk_plain(regs, ckpt, ckpt, state, k)
            for segments in WALK_FORMS:
                check("tb_walk", tb.tb_walk(regs, ckpt, ckpt, state, k,
                                            segments=segments), want_rs,
                      f"streaming walk {streams} x {sb}, "
                      f"segments={segments}")
            check("tb_walk", got, tb._regs_bytes(
                want_rs, emit, ckpt, ckpt, regs.shape[0] * ckpt - emit),
                f"streaming walk bytes {streams} x {sb}")

        rec = stream.cell(dev, streams, n_blocks, blk, streams + n_blocks,
                          hold=hold)
        assert rec["ok"], {k: rec[k] for k in (
            "launches", "equal_plain", "equal_whole")}
        first = first or rec["launches"]
        print(f"{tag} streaming {streams} streams x {sb} bits in "
              f"{n_blocks} blocks of {blk} ({streams * n_blocks} folded "
              f"frames; layout {rec['layout']}): {rec['ms']:.3f} ms "
              f"resident ({parts_text(rec['parts_ms'])}), "
              f"{rec['gsym_s']:.1f} Gsym/s ({fused_gsym:.1f} for "
              f"cuda_fused's kernels at {B_MAIN} x {FB_MAIN}); "
              f"{rec['bit_errors']} bit errors; equal to the plain path on "
              f"the card and, on {stream.WHOLE_ROWS} streams, to the "
              f"whole-stream decode")
    return first


def session_phase(dev, tag, check) -> dict:
    """Phase 15: StreamSession on 128 kbit/s streams (``tools.session``);
    returns the launches of one push."""
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import traceback as tb
    from viterbi_tpu_torch.parallel import StreamSession
    from viterbi_tpu_torch.tools import session
    B, n = SESSION_STREAMS, SESSION_PUSHES
    data, tail, whole = session.stream(dev, B, n, FB_MAIN, seed=15)

    def hold(fwd, walk):
        """Kernels A and B against their plain versions on the last
        push."""
        for args, kw, (regs, metrics) in fwd:
            r_p, m_p = acs_cuda.forward_regs_plain(*args, **kw)
            check("acs_regs", regs, r_p, "session push")
            check("acs_regs", metrics, m_p, "session push metrics")
        (regs, fbits, ckpt, gap), kw, (rs, got) = walk[0]
        want_rs = tb.tb_walk_plain(regs, ckpt, gap, kw.get("anchor"))
        check("tb_walk", rs, want_rs, "session push walk")
        check("tb_walk", got, tb._regs_bytes(want_rs, fbits, ckpt, gap,
                                             kw["tail"]),
              "session push bytes")

    one = session.chunks(dev, data, tail, whole, 1, FB_MAIN, hold=hold)
    five = session.chunks(dev, data, tail, whole, SESSION_FRAMES, FB_MAIN,
                          hold=hold)
    for rec in (one, five):
        assert rec["ok"], {k: rec.get(k) for k in (
            "match_one_shot", "none_held_back", "launches_per_push")}
        assert rec["every_push_emitted"], "a push emitted nothing"
    assert one["push_ms_p50"] < FRAME_MS, \
        f"push p50 {one['push_ms_p50']:.2f} ms over the {FRAME_MS} ms frame"
    # the plain session on the CPU against the kernel session, a few
    # streams and pushes
    ps, pn = SESSION_PLAIN
    step = 4 * FB_MAIN
    pdata = np.ascontiguousarray(data[:ps, :pn * step])
    ptail = np.ascontiguousarray(tail[:ps])
    sides = []
    for sess_p in (StreamSession(ps, use_kernels=False, device="cpu"),
                   StreamSession(ps)):
        o = [sess_p.push(pdata[:, i:i + step])
             for i in range(0, pdata.shape[1], step)]
        o.append(sess_p.flush(ptail))
        sides.append(np.concatenate(o, axis=1))
    assert np.array_equal(sides[0], sides[1]), "session kernels != plain"
    per_push = {k: int(v) for k, v in one["launches_per_push"].items()}
    print(f"{tag} session {B} streams at {FB_MAIN * 1000 // 24000} kbit/s, "
          f"{FB_MAIN}-bit chunks: {n} pushes, push "
          f"{one['push_ms_p50']:.3f} ms p50, {one['push_ms_max']:.3f} ms "
          f"max (the first {one['first_push_ms']:.3f} ms) against "
          f"{FRAME_MS} ms a frame (the last push's "
          f"{parts_text(one['last_push_parts_ms'])}); flush "
          f"{one['flush_ms']:.3f} ms; emit lag {one['emit_lag_bits_max']} "
          f"bits; {per_push} launches a push; equal to the one-shot decode "
          f"through kernels A and B, and with chunks of {SESSION_FRAMES} "
          f"frames (push {five['push_ms_p50']:.3f} ms p50, "
          f"{five['push_ms_max']:.3f} max; the last push's "
          f"{parts_text(five['last_push_parts_ms'])}); the plain session on "
          f"the CPU equal on {ps} streams x {pn} pushes")
    return per_push


def ingest_phase(dev, tag, packed) -> dict:
    """Phase 16: the native host library and the pipelined feed
    (``tools.ingest``); returns the launches of the pipelined run."""
    import torch
    from viterbi_tpu_torch.ops import acs_cuda, counts
    from viterbi_tpu_torch.tools import ingest
    lib = ingest.native_checks()
    frames = packed[:RING_FRAMES].view(np.uint32)
    ring_s = ingest.ring(frames, len(frames))
    batches = [np.roll(packed, k * (B_MAIN // INGEST_BATCHES), axis=0)
               for k in range(INGEST_BATCHES)]
    secs, launches = ingest.turns(
        batches, lambda t: acs_cuda.decode(t, FB_MAIN, packed="bt"), dev,
        INGEST_ROUNDS)
    assert counts.only({"acs_regs": INGEST_BATCHES,
                        "tb_walk": INGEST_BATCHES}, launches), launches
    med = {k: statistics.median(v) for k, v in secs.items()}
    spread = {k: f"{med[k]:.1f} ({min(v):.1f}-{max(v):.1f})"
              for k, v in secs.items()}
    mb = packed.nbytes / 1e6
    print(f"{tag} ingest: native host lib built ({lib}), equal to its numpy "
          f"fall-backs; a frame ring fed by 4 threads moved {len(frames)} "
          f"frames of {frames.shape[1]} words in {1e3 * ring_s:.1f} ms; "
          f"{INGEST_BATCHES} packed batches of {B_MAIN} x {FB_MAIN} "
          f"({mb:.0f} MB each) through acs_cuda.decode, ms for all, median "
          f"(range) of {len(secs['depth 2'])} runs each in turns: one "
          f"pageable call at a time {spread['serial']}, pipelined depth 1 "
          f"{spread['depth 1']}, depth 2 {spread['depth 2']} (medians: "
          f"depth 2 {med['depth 1'] / med['depth 2']:.2f}x depth 1, "
          f"{med['serial'] / med['depth 2']:.2f}x serial; host threads "
          f"{torch.get_num_threads()}; every run "
          f"{ {k: [round(x, 1) for x in v] for k, v in secs.items()} }), "
          f"all equal")
    return launches


# --- phase 17: several processes on one card ---------------------------------


def rank_mesh(name, n_data, n_seq, rank, store):
    """This rank's place in a mesh of the first n_data * n_seq ranks of the
    job, on cuda:0 over gloo; None for a rank outside it."""
    import datetime
    import torch
    import torch.distributed as dist
    from viterbi_tpu_torch.parallel import mesh
    if rank >= n_data * n_seq:
        return None
    return mesh.make_mesh(
        n_data, n_seq, rank=rank, world_size=n_data * n_seq,
        store=dist.PrefixStore(name, store), device=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def timed_path(fn, record=(), runs: int = 3,
               kernels=("acs_regs", "tb_walk")):
    """(the launches of ``kernels`` in one call, each of which must launch,
    its output, the median wall seconds of ``runs`` more calls, each ended
    by a synchronise, and the first call's calls of each ``(module,
    name)`` in ``record``)."""
    import torch
    from viterbi_tpu_torch.tools import _record
    with contextlib.ExitStack() as stack:
        calls = [stack.enter_context(_record.recorded(*r))
                 for r in record]
        _record.zero_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = {k: _record.launches()[k] for k in kernels}
    for name, count in launches.items():
        assert count > 0, f"a rank never launched {name}: {launches}"
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return launches, out, statistics.median(walls), calls


def in_turns(m, fn):
    """``fn()`` (None: nothing) in this rank's turn, one rank of mesh ``m``
    at a time: processes on one card take turns on it, so a device time
    taken while others run counts theirs too. Every rank of ``m`` calls
    it. Returns ``fn``'s result."""
    import torch
    from viterbi_tpu_torch.parallel import mesh

    def barrier():
        # a row, then a column: once both are through, every rank arrived
        for axis in (mesh.SEQ_AXIS, mesh.DATA_AXIS):
            mesh.all_gather_rows(m.groups[axis], torch.zeros(1))

    out = None
    for turn in range(m.shape[mesh.DATA_AXIS] * m.shape[mesh.SEQ_AXIS]):
        barrier()
        if turn == m.rank and fn is not None:
            out = fn()
    barrier()
    return out


def hold_ring_call(fwd, walk, check, what, rows=None) -> None:
    """Kernels A and B of one recorded ring call (``forward_regs`` twice,
    ``chainback_regs_cuda_anchored`` once) against their plain versions on
    the call's own inputs, at the call's full depth, on its first ``rows``
    frames (None: all; the frames are independent). The plain versions
    run on host copies: several ranks' small launches would take turns
    on the one card."""
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import traceback as tb
    n = slice(rows)
    for (words, nsteps), kw, (regs, metrics) in fwd:
        r_p, m_p = acs_cuda.forward_regs_plain(
            words[n].cpu(), nsteps, **dict(
                kw, initial_metrics=kw["initial_metrics"][n].cpu()))
        check("acs_regs", regs[:, :, n], r_p, f"{what}, {nsteps} steps")
        check("acs_regs", metrics[n], m_p, f"{what}, {nsteps} steps")
    (regs, k, state, emit, ckpt), _, got = walk[0]
    want_rs = tb.tb_walk_plain(regs[:, :, n].cpu(), ckpt, ckpt,
                               state[n].cpu(), k[n].cpu())
    check("tb_walk", got[n], tb._regs_bytes(
        want_rs, emit, ckpt, ckpt, regs.shape[0] * ckpt - emit),
        f"{what} walk, {regs.shape[0]} checkpoints of {ckpt}")


def several_rank(rank, world_size, store, data_dir):
    """One rank of phase 17 (a spawned process): every path it takes part
    in, checked bit for bit against what the parent wrote; returns each
    path's launches, wall and device ms, and the kernels' max errors."""
    import torch
    import viterbi_tpu_torch
    from viterbi_tpu_torch import api
    from viterbi_tpu_torch.models import dab
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import traceback as tb
    from viterbi_tpu_torch.parallel import batch, mesh, streaming
    from viterbi_tpu_torch.runtime import dispatch
    from viterbi_tpu_torch.tools import _record
    torch.cuda.set_device(0)
    viterbi_tpu_torch.initialize()
    variant = dispatch.VARIANTS[dispatch.state().variant]
    assert variant == "cuda_fused", f"rank {rank} took {variant}"
    # every rank of the job, set up before any path starts: a rank that
    # still made its CUDA context slowed the card for the others
    job = rank_mesh("job", world_size, 1, rank, store)
    d = Path(data_dir)
    load = lambda name: np.load(d / f"{name}.npy", mmap_mode="r")
    res = {"paths": {}, "errs": {"acs_regs": 0, "tb_walk": 0}}

    def check(kernel, got, want, what):
        e = max_abs_err(got, want)
        res["errs"][kernel] = max(res["errs"][kernel], e)
        if e:
            raise AssertionError(f"rank {rank}: {kernel} differs from its "
                                 f"plain version ({what}): max abs err {e}")

    def record(path, launches=None, wall_s=None, parts=None):
        """A path's record; ``parts`` maps each part of a call to a
        function that returns its device ms, timed in this rank's turn of
        the job. Every rank calls it after each path, one outside the path
        with nothing."""
        timed = in_turns(job, parts and (
            lambda: {k: f() for k, f in parts.items()}))
        if parts:
            res["paths"][path] = {"launches": launches,
                                  "wall_ms": 1e3 * wall_s, "parts": timed}

    # DP: the main-path batch over SHARD_RANKS ranks
    m = rank_mesh("sharded", SHARD_RANKS, 1, rank, store)
    if m is not None:
        syms = load("dp_syms")
        launches, out, wall, _ = timed_path(
            lambda: batch.decode_sharded(syms, FB_MAIN, m))
        got = out.cpu().numpy()
        assert np.array_equal(got, load("dp_want")), \
            "decode_sharded != the one-process deconvolve_batch"
        assert np.array_equal(got[:8], load("dp_golden")), \
            "decode_sharded != golden"
        rows = torch.from_numpy(np.ascontiguousarray(
            mesh.local_rows(syms, m), dtype=np.int32)).cuda()
        record("sharded", launches, wall, {"A + B": lambda: cuda_ms(
            lambda: api._decode_tensor(rows, FB_MAIN, variant), 5)[0]})
        del rows, out
    else:
        record("sharded")
    # the ring at STREAM_TPU.json's shape, on each mesh
    for n_data, n_seq in RING_MESHES:
        m = rank_mesh(f"ring{n_data}x{n_seq}", n_data, n_seq, rank, store)
        if m is None:
            record(f"ring {n_data}x{n_seq}")
            continue
        rsyms = load("ring_syms")
        data = rsyms[:, :4 * RING_BITS]
        tail = rsyms[:, 4 * RING_BITS:]
        dec = streaming.make_stream_decoder(m, RING_BITS)
        launches, out, wall, (fwd, walk) = timed_path(
            lambda: dec(data, tail), ((acs_cuda, "forward_regs"),
                                      (tb, "chainback_regs_cuda_anchored")))
        assert np.array_equal(out.cpu().numpy(), load(f"ring_want_{n_seq}")),\
            f"ring {n_data} x {n_seq} != the local decoder of {n_seq} blocks"
        hold_ring_call(fwd, walk, check, f"ring {n_data} x {n_seq} rank "
                       f"{rank}", RING_HOLD_ROWS)
        (wa, wkw, _), (fa, fkw, _) = fwd
        record(f"ring {n_data}x{n_seq}", launches, wall, {
            "A warm-up": lambda: cuda_ms(
                lambda: acs_cuda.forward_regs(*wa, **wkw), 5)[0],
            "A full pass": lambda: cuda_ms(
                lambda: acs_cuda.forward_regs(*fa, **fkw), 5)[0],
            "B": lambda: cuda_ms(
                lambda: tb.chainback_regs_cuda_anchored(*walk[0][0]), 5)[0]})
        del fwd, walk, out, wa, fa
    # and on every frame of a small ring's calls
    streams, n_seq, blk = RING_HOLD
    m = rank_mesh("hold", 1, n_seq, rank, store)
    if m is not None:
        hsyms = torch.from_numpy(np.array(load("hold_syms"))).cuda()
        sb = n_seq * blk
        with _record.recorded(acs_cuda, "forward_regs") as fwd, \
                _record.recorded(tb, "chainback_regs_cuda_anchored") \
                as walk:
            out = streaming.decode_stream(hsyms, sb, m)
        assert torch.equal(out, streaming.make_local_stream_decoder(
            sb, n_seq)(hsyms[:, :4 * sb], hsyms[:, 4 * sb:]))
        hold_ring_call(fwd, walk, check, f"small ring rank {rank}")
        del fwd, walk
    # the DAB+ ensemble: phase 8's superframes over SHARD_RANKS ranks
    m = rank_mesh("ensemble", SHARD_RANKS, 1, rank, store)
    if m is not None:
        esyms = load("ens_syms")
        launches, (audio, errors), wall, _ = timed_path(
            lambda: dab.decode_ensemble_sharded(esyms, SF_KBPS, m),
            kernels=("acs_regs", "tb_walk", "rs_superframes"))
        assert np.array_equal(audio.cpu().numpy(), load("ens_audio")) and \
            np.array_equal(errors.cpu().numpy(), load("ens_errors")), \
            "decode_ensemble_sharded != the one-process chain"
        rows = torch.from_numpy(np.ascontiguousarray(
            mesh.local_rows(esyms, m), dtype=np.int32)).cuda()
        record("ensemble", launches, wall, {"chain": lambda: cuda_ms(
            lambda: dab.decode_audio_superframes(rows, SF_KBPS), 5)[0]})
    else:
        record("ensemble")
    return res


def several_phase(dev, tag, syms, out, expect8, sf) -> dict:
    """Phase 17: the data-parallel decode, the ring and the ensemble in
    ranks that share the card, then the scaling sweep; returns the
    launches a rank of each path made (for the kernels line) and the
    kernels' max errors in the ranks."""
    import torch
    from viterbi_tpu_torch.harness import channel, scaling
    from viterbi_tpu_torch.parallel import distributed, streaming
    d = ROOT / "build" / "chip_smoke" / "phase17"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # symbols as bytes: only a symbol's low byte counts
    np.save(d / "dp_syms.npy", syms.astype(np.uint8))
    np.save(d / "dp_want.npy", out)
    np.save(d / "dp_golden.npy", expect8)
    gen = torch.Generator(device=dev).manual_seed(17)
    bits = torch.randint(0, 2, (RING_STREAMS, RING_BITS), generator=gen,
                         device=dev)
    rsyms = channel.soft_on_device(bits, False, gen)
    data, tail = rsyms[:, :4 * RING_BITS], rsyms[:, 4 * RING_BITS:]
    for n_seq in sorted({n for _, n in RING_MESHES}):
        want = streaming.make_local_stream_decoder(RING_BITS, n_seq)(data,
                                                                     tail)
        np.save(d / f"ring_want_{n_seq}.npy", want.cpu().numpy())
    nerr = channel.bit_errors_on_device(want, bits)
    np.save(d / "ring_syms.npy", rsyms.to(torch.uint8).cpu().numpy())
    del bits, rsyms, data, tail, want
    streams, n_seq, blk = RING_HOLD
    np.save(d / "hold_syms.npy",
            channel.make_frames(streams, n_seq * blk, seed=17)[1])
    sf_syms, sf_audio, sf_errors = sf
    np.save(d / "ens_syms.npy", sf_syms.astype(np.uint8))
    np.save(d / "ens_audio.npy", sf_audio)
    np.save(d / "ens_errors.npy", sf_errors)
    print(f"several processes: inputs and one-process results written in "
          f"{time.perf_counter() - t0:.1f} s ({nerr} bit errors in the "
          f"ring's streams through the local decoder)")
    # the blocks this process's allocator keeps would leave the ranks too
    # little device memory: their allocators would free and synchronise
    # inside the timed calls
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"several processes: {free / 2**30:.1f} of {total / 2**30:.1f} GiB "
          f"of device memory free for the ranks")
    t0 = time.perf_counter()
    ranks = distributed.run_ranks(several_rank, RANKS, (str(d),),
                                  timeout=RANK_LIMIT_S)
    print(f"several processes: {RANKS} ranks on {dev} over gloo, "
          f"{time.perf_counter() - t0:.1f} s from spawn to the last rank's "
          f"end")
    errs = {k: max(r["errs"][k] for r in ranks) for k in ("acs_regs",
                                                         "tb_walk")}
    launches = {}
    for path in ranks[0]["paths"]:
        took = [r["paths"][path] for r in ranks if path in r["paths"]]
        per_rank = [t["launches"] for t in took]
        assert all(p == per_rank[0] for p in per_rank), (path, per_rank)
        print(f"{tag} {path}: {len(took)} ranks, each launching "
              f"{per_rank[0]}; wall ms a call (median of 3, the ranks at "
              f"once) by rank {[round(t['wall_ms'], 2) for t in took]}; "
              f"device ms of a call's parts, each rank alone on the card "
              f"(CUDA events): "
              + "; ".join(parts_text(t["parts"]) for t in took))
        key = path.split()[0]
        launches.setdefault(key, per_rank[0])
    print(f"several processes: kernels A and B bit-identical to their plain "
          f"versions in every rank, on {RING_HOLD_ROWS} frames of each ring "
          f"call at its full depth and on the whole of a "
          f"{RING_HOLD[0]}-stream ring of {RING_HOLD[1]} x {RING_HOLD[2]}-bit "
          f"blocks; every path equal to its one-process counterpart")
    t0 = time.perf_counter()
    sweep = scaling.sweep(SWEEP_FRAMES, FB_MAIN, loops=3, repeats=2,
                          max_ranks=RANKS, device=dev, timeout=RANK_LIMIT_S)
    for n, r in sweep.items():
        print(f"{tag} scaling: ranks={n} x {SWEEP_FRAMES} frames of "
              f"{FB_MAIN} bits on one card: {r['mbit_s']:.1f} Mbit/s, "
              f"efficiency {r['efficiency']:.3f}, envelope "
              f"{r['predicted_envelope']}")
    print(f"scaling sweep: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "errs": errs}


# --- phase 18: the entry points and the evidence tools ----------------------


def tools_phase(dev, tag) -> dict:
    """Phase 18: ``entry()``, ``dryrun_multichip(RANKS)`` on this card, the
    parity record's quick run and a corner of the overlap sweep, each
    through the port's entry points; returns each one's launches (the
    dryrun: its first rank's, all of its paths together)."""
    import torch
    from viterbi_tpu_torch import entry, golden
    from viterbi_tpu_torch.tools import _record, overlap_sweep, parity
    paths, secs = {}, {}
    # entry(): kernels A and B, equal to golden and to its plain form
    t0 = time.perf_counter()
    fn, (syms,) = entry.entry()
    _record.zero_launches()
    out = fn(syms)
    torch.cuda.synchronize()
    paths["entry"] = _record.launches()
    assert not _record.missing(paths["entry"], ("acs_regs", "tb_walk")), \
        paths["entry"]
    host = syms.cpu()
    assert np.array_equal(out.cpu().numpy(), golden.deconvolve_many(
        entry.FRAMEBITS, host.numpy())), "entry() != golden"
    pfn, (psyms,) = entry.entry(device="cpu")
    assert torch.equal(psyms, host) and torch.equal(pfn(psyms), out.cpu()), \
        "entry() != its plain form"
    secs["entry"] = time.perf_counter() - t0
    # dryrun_multichip on this card: every rank launches A and B a path
    t0 = time.perf_counter()
    ranks = entry.dryrun_multichip(RANKS)
    for r, res in enumerate(ranks):
        for path, counts in res["launches"].items():
            lost = _record.missing(counts, ("acs_regs", "tb_walk"))
            assert not lost, f"dryrun rank {r}: {path} never launched {lost}"
    paths["dryrun"] = {k: sum(c[k] for c in ranks[0]["launches"].values())
                       for k in _record.KERNELS}
    secs["dryrun"] = time.perf_counter() - t0
    # the parity record's quick run: every kernel of ops.counts launches
    # (the T-DMB chain's K and I's packets entry among them), 0 mismatches
    t0 = time.perf_counter()
    doc = parity.run(quick=True, device=dev)
    assert doc["ok"], {k: doc[k] for k in ("mismatches",
                                            "kernels_not_launched")}
    assert not _record.missing(doc["launches"], _record.KERNELS) and \
        doc["launches"]["deinterleave"] and doc["launches"]["rs_packets"], \
        doc["launches"]
    paths["parity"] = doc["launches"]
    secs["parity"] = time.perf_counter() - t0
    # the overlap sweep at 0 dB, seed 0, overlaps 24 and 96, both forms
    t0 = time.perf_counter()
    sweep = overlap_sweep.run(device=dev, seeds=(0,), ebn0s=(0.0,),
                              overlaps=(24, 96), warmups=())
    paths["overlap_sweep"] = sweep["launches"]
    assert sweep["ok"] and sweep["reference_cells_compared"] == 2, \
        {k: sweep[k] for k in ("reference_cells_compared",
                               "reference_cells_differing",
                               "kernel_cells_differing",
                               "kernels_not_launched")}
    secs["overlap_sweep"] = time.perf_counter() - t0
    cells = "; ".join(
        f"overlap {c['overlap']} (runs as {c['effective_overlap']}, warm-up "
        f"{c['effective_warmup']}): {c['mismatch_bits']} bits in "
        f"{c['mismatch_frames']} frames" for c in sweep["kernel_cells"])
    print(f"{tag} entry points and tools: entry() through kernels A and B "
          f"equal to golden and to its plain form; dryrun_multichip({RANKS}) "
          f"on {dev}, kernels A and B in every rank's every path "
          f"({[sorted(r['launches']) for r in ranks][0]}); parity --quick "
          f"{len(doc['sections'])} sections, 0 mismatches, launches "
          f"{doc['launches']}; overlap sweep at 0 dB, seed 0: the plain form "
          f"equal to OVERLAP_SWEEP.json's cells, the kernel form equal to it "
          f"at the effective overlap ({cells}); seconds "
          f"{ {k: round(v, 1) for k, v in secs.items()} }")
    return paths


# --- phase 19: first use in a fresh process --------------------------------

# Run by ``python3 -c`` from the repository root, with a config file of
# its own: nothing in this process has set the dispatcher up. Prints one
# JSON object as its last line.
FIRST_USE_CODE = """
import json
import numpy as np
import torch
import viterbi_tpu_torch
from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.models import dab
from viterbi_tpu_torch.ops import counts
from viterbi_tpu_torch.parallel import StreamSession
from viterbi_tpu_torch.runtime import dispatch

res = {}
st = dispatch.state()
assert st.device is None, f"set up at import: {st.device}"
_, syms = channel.make_frames(64, 3072, seed=19)
counts.zero_launches()
ret, out = viterbi_tpu_torch.deconvolve_batch(3072, syms)
torch.cuda.synchronize()
res["deconvolve_batch"] = counts.launches()
res["variant"] = dispatch.VARIANTS[st.variant]
res["device"] = str(st.device)
assert ret == 0 and out.shape == (64, 384), (ret, out.shape)
assert np.array_equal(out[:4], golden.deconvolve_many(3072, syms[:4])), \
    "first-use decode != golden"

rng = np.random.default_rng(19)
msgs = rng.integers(0, 256, (4, C.RS_KK), dtype=np.uint8)
cws = golden.rs_encode_many(msgs).astype(np.int64)
cws[1, :3] ^= 0x5A
sf = cws.T.reshape(-1).astype(np.uint8)
buf = np.zeros(4 * C.RS_KK, np.uint8)
counts.zero_launches()
errors = viterbi_tpu_torch.rs_check_superframe(sf, 0, 4, buf)
torch.cuda.synchronize()
res["rs_check_superframe"] = counts.launches()
g_err, g_out = golden.rs_check_superframe(sf, 4)
assert errors == g_err == 3 and np.array_equal(buf, g_out), \
    (errors, g_err)

cfg = dab.SubchannelConfig(32)
frames = rng.integers(0, 256, (2 * dab.SUPERFRAME_FRAMES,
                               C.RATE * (cfg.framebits + C.TAIL_BITS)))
host = frames.reshape(2, dab.SUPERFRAME_FRAMES, -1).astype(np.int32)
audio, errs = dab.decode_audio_superframes(host, 32)
assert audio.is_cuda and errs.is_cuda, (audio.device, errs.device)
cpu_audio, cpu_errs = dab.decode_audio_superframes(host, 32, device="cpu")
assert torch.equal(audio.cpu(), cpu_audio) and \
    torch.equal(errs.cpu(), cpu_errs), "superframes: card != CPU"
res["superframes_device"] = str(audio.device)
res["session_device"] = str(StreamSession(4).device)
assert res["session_device"].startswith("cuda"), res["session_device"]
print(json.dumps(res))
"""


def first_use_phase(tag) -> dict:
    """Phase 19: the exports, a chain and a session in a process that
    never called initialize(); returns the launches of its two export
    calls together."""
    cfg = ROOT / "build" / "chip_smoke" / "first_use" / "viterbi.txt"
    cfg.parent.mkdir(parents=True, exist_ok=True)
    cfg.unlink(missing_ok=True)
    from viterbi_tpu_torch.runtime import config as config_mod
    env = dict(os.environ, **{config_mod.CONFIG_ENV: str(cfg)})
    proc = subprocess.run([sys.executable, "-c", FIRST_USE_CODE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=FIRST_USE_LIMIT_S)
    if proc.returncode != 0:
        raise AssertionError(f"first-use process exited with "
                             f"{proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    dec, rs = res["deconvolve_batch"], res["rs_check_superframe"]
    assert res["variant"] == "cuda_fused", res
    assert res["device"].startswith("cuda"), res
    assert dec["acs_regs"] == 1 and dec["tb_walk"] == 1, dec
    assert rs["rs_superframes"] == 1 and rs["rs_decode"] == 0, rs
    assert res["superframes_device"].startswith("cuda"), res
    print(f"{tag} first use, no initialize(): {res['variant']} on "
          f"{res['device']}; deconvolve_batch launches {dec}; "
          f"rs_check_superframe launches {rs}; decode_audio_superframes of "
          f"a host array on {res['superframes_device']}, equal to the CPU's "
          f"plain path; StreamSession on {res['session_device']}")
    return {k: dec[k] + rs[k] for k in dec}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import viterbi_tpu_torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch import golden
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.ops import _build, acs_cuda, counts
    from viterbi_tpu_torch.ops import traceback as tb
    from viterbi_tpu_torch.runtime import config as config_mod
    from viterbi_tpu_torch.runtime import dispatch

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(card)
    tag = f"[{card}]"

    # --- phase 2: build -------------------------------------------------
    # both libraries at once, one nvcc per source
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        paths = list(pool.map(lambda lib: _build.build(library=lib),
                              (_build.MAIN, _build.PROBES)))
    _build.load()
    _build.load(library=_build.PROBES)
    print(f"build: {time.perf_counter() - t0:.1f} s -> {paths[0]}, "
          f"{paths[1].name}")
    for lib in (_build.MAIN, _build.PROBES):
        for name, (regs, st, ld) in ptxas_summary(
                _build.build_log(library=lib)).items():
            if lib is _build.MAIN or "kablate" in name or "rs_" in name:
                print(f"  ptxas: {name}: {regs} registers, spills {st} B "
                      f"stored, {ld} B loaded")
    # kernels A, C and E: one lane a frame and four (A also a warp a
    # frame), packed and unpacked symbols (E: six variants, packed); none
    # may spill
    forward = {n: v for lib in (_build.MAIN, _build.PROBES)
               for n, v in ptxas_summary(_build.build_log(library=lib)).items()
               if any(k in n for k in ("acs_regs_kernel", "acs_words_kernel",
                                       "kablate_kernel"))}
    for kernel, count in (("acs_regs_kernel", 6), ("acs_words_kernel", 4),
                          ("kablate_kernel", 12)):
        names = [n for n in forward if kernel in n]
        assert len(names) == count, f"{kernel}'s instantiations: {names}"
    for name, (regs, st, ld) in forward.items():
        assert st == 0 and ld == 0, f"{name} spills: {st}/{ld} bytes"
    # kernel I (superframes at two capacities, uint8 and int32 codewords):
    # at most 64 registers, so four blocks of 256 an SM, and no spills;
    # the probe's build with the table syndromes is printed above
    for lib in (_build.MAIN, _build.PROBES):
        rs_k = {n: v for n, v in ptxas_summary(
            _build.build_log(library=lib)).items()
            if "rs_superframes_kernel" in n or "rs_codewords_kernel" in n}
        assert len(rs_k) == 4, f"kernel I's instantiations: {list(rs_k)}"
        for name, (regs, st, ld) in rs_k.items():
            assert regs <= 64, f"{name}: {regs} registers"
            assert lib is _build.PROBES or st == ld == 0, \
                f"{name} spills {st}/{ld} bytes"
    # kernel I's RS(204,188) entry (two blocks of 256 an SM: at most 128
    # registers) and kernel K (a full SM of threads: at most 32); no spills
    outer = {n: v for n, v in ptxas_summary(
        _build.build_log(library=_build.MAIN)).items()
        if "rs_packets_kernel" in n or "deinterleave_kernel" in n}
    assert len(outer) == 2, f"kernels I (packets) and K: {list(outer)}"
    for name, (regs, st, ld) in outer.items():
        cap = 128 if "rs_packets_kernel" in name else 32
        assert regs <= cap, f"{name}: {regs} registers"
        assert st == ld == 0, f"{name} spills {st}/{ld} bytes"
    clock_hz = sm_clock_hz()
    print(f"bounds against {HBM_BYTES_S / 1e12} TB/s and "
          f"{INT_LANES * SMS * clock_hz / 1e12:.2f} T int32 ops/s "
          f"({SMS} SMs x {INT_LANES} lanes x {clock_hz / 1e6:.0f} MHz)")

    # --- phase 3: kernels vs plain versions ------------------------------
    rng = np.random.default_rng(2024)
    errs = dict.fromkeys(("acs_regs", "tb_walk", "acs_words", "tb_words",
                          "kablate", "kdtype_op", "kdtype_chain",
                          "kilp_streams", "rs_decode", "rs_synd_table",
                          "depuncture", "deinterleave", "rs_packets"), 0)

    def check(kernel, got, want, what):
        e = max_abs_err(got, want)
        errs[kernel] = max(errs[kernel], e)
        if e:
            raise AssertionError(f"{kernel} differs from its plain version "
                                 f"({what}): max abs err {e}")

    # (framebits, layout, front_pad, entry metrics): the seven DAB
    # main-path sizes, the non-6 checkpoint class (64 -> nsteps 70,
    # ckpt 14), a partial last checkpoint (32 -> nsteps 38, ckpt 24)
    cases = [(192, False, 0, True), (768, "bt", 12, False),
             (1536, True, 0, True), (2304, False, 0, False),
             (3072, "bt", 0, True), (3072, False, 6, True),
             (4608, True, 0, False), (9216, "bt", 0, True),
             (64, False, 0, True), (64, "bt", 0, False),
             (32, "bt", 0, True), (32, False, 0, False)]
    t0 = time.perf_counter()
    for fb, packed, pad, with_init in cases:
        n = fb + C.TAIL_BITS
        raw = rng.integers(0, 256, (B_CHECK, C.RATE * n), dtype=np.int32)
        if packed:
            words = acs_cuda.pack_symbols_host(raw)
            host = words if packed == "bt" else np.ascontiguousarray(words.T)
        else:
            host = raw
        syms = torch.from_numpy(host).to(dev)
        init = (torch.from_numpy(rng.integers(0, 256, (B_CHECK, 64))
                                 .astype(np.int32)).to(dev)
                if with_init else None)
        what = f"framebits {fb}, packed={packed}, front_pad={pad}"
        kw = dict(initial_metrics=init, packed=packed, front_pad=pad)
        r_p, m_p = acs_cuda.forward_regs_plain(syms, n, **kw)
        for lanes in REGS_FORMS:
            r_k, m_k = acs_cuda.forward_regs(syms, n, lanes=lanes, **kw)
            check("acs_regs", r_k, r_p, f"{what}, lanes={lanes} regs")
            check("acs_regs", m_k, m_p, f"{what}, lanes={lanes} metrics")
        # kernel B on those checkpoints: terminated, anchored, and
        # anchored at an interior checkpoint
        K = r_k.shape[0]
        ckpt = acs_cuda.choose_ckpt(n + pad)
        gap = n + pad - (K - 1) * ckpt
        anc = torch.from_numpy(rng.integers(0, 64, B_CHECK)
                               .astype(np.int32)).to(dev)
        anck = torch.from_numpy(rng.integers(0, K, B_CHECK)
                                .astype(np.int32)).to(dev)
        for a, ak in ((None, None), (anc, None), (anc, anck)):
            check("tb_walk", tb.tb_walk(r_k, ckpt, gap, a, ak),
                  tb.tb_walk_plain(r_k, ckpt, gap, a, ak),
                  what + f" anchor={a is not None} "
                         f"anchor_k={ak is not None}")
    # tail-biting form: no tail, best-state anchor, wrap_last6 fix-up
    fb = 768
    raw = rng.integers(0, 256, (B_CHECK, C.RATE * fb), dtype=np.int32)
    regs, _ = acs_cuda.forward_regs(torch.from_numpy(raw).to(dev), fb,
                                    ckpt=24)
    anc = torch.from_numpy(rng.integers(0, 64, B_CHECK).astype(np.int32))
    got = tb.chainback_regs_cuda(regs, fb, ckpt=24, tail=0,
                                 anchor=anc.to(dev), wrap_last6=True)
    want = tb.chainback_regs_cuda(regs.cpu(), fb, ckpt=24, tail=0,
                                  anchor=anc, wrap_last6=True)
    check("tb_walk", got.cpu(), want, "wrap_last6")
    torch.cuda.synchronize()
    print(f"kernels A, B vs plain: {len(cases)} shapes bit-identical, A in "
          f"every form ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    check_walk_forms(rng, dev, check)
    torch.cuda.synchronize()
    print(f"kernel B vs plain in every form {WALK_FORMS}: batches "
          f"{(*RAGGED, B_CHECK)} x ({len(WALK_SHAPES)} shapes of random "
          f"registers, 4 of kernel A's with the byte output), anchors and "
          f"interior anchors bit-identical ({time.perf_counter() - t0:.1f} s)")
    # ragged last warps, a reset inside a six-step window (front pads that
    # six does not divide), every checkpoint period: A and C in every form
    t0 = time.perf_counter()
    ragged = [(64, "bt", 6, None), (96, False, 0, None), (32, True, 12, 14),
              (768, "bt", 0, 24)]
    for batch in RAGGED:
        for fb, packed, pad, ckpt in ragged:
            hold_forward(dev, rng, check, batch, fb, packed, pad, ckpt)
    resets = [(pad, ck) for pad in (2, 4, 8, 10, 14, 20) for ck in (24, 14)]
    for pad, ck in resets:
        hold_forward(dev, rng, check, 33, 96, "bt", pad, ck, words_too=False)
    for ck in range(2, 28, 2):
        hold_forward(dev, rng, check, 65, 90, False, 0, ck, words_too=False)
    torch.cuda.synchronize()
    print(f"kernels A, C vs plain in every form: batches {RAGGED} x "
          f"{len(ragged)} shapes, {len(resets)} resets inside a window, "
          f"checkpoint periods 2..26 bit-identical "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    check_words_kernels(rng, dev, check)
    torch.cuda.synchronize()
    print(f"kernels C, D vs plain: {len(WORDS_FRAMEBITS)} x 3 layouts x 2 "
          f"entry metrics and {len(WALK_FRAMEBITS)} x 2 walks bit-identical "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ts_times, ts_bounds = tdmb_kernels(dev, tag, check, clock_hz)
    print(f"kernels K and I's RS(204,188) entry vs plain: "
          f"{time.perf_counter() - t0:.1f} s")

    # --- phase 4: the main path through the public API --------------------
    cfg_path = ROOT / "build" / "chip_smoke" / "viterbi.txt"
    cfg_path.parent.mkdir(parents=True, exist_ok=True)
    cfg_path.unlink(missing_ok=True)
    os.environ[config_mod.CONFIG_ENV] = str(cfg_path)
    viterbi_tpu_torch.initialize()
    st = dispatch.state()
    variant = dispatch.VARIANTS[st.variant]
    assert variant == "cuda_fused", f"initialize() picked {variant}"
    assert st.device.type == "cuda"

    t0 = time.perf_counter()
    bits, syms = channel.make_frames(B_MAIN, FB_MAIN, seed=7,
                                     ebn0_db=EBN0_DB)
    packed = acs_cuda.pack_symbols_host(syms)
    ladder = {}
    for kbps in viterbi_tpu_torch.api.DAB_LADDER_KBPS:
        lfb = 24 * kbps
        ladder[kbps] = channel.make_frames(B_CHECK, lfb, seed=kbps)
    print(f"frames: {time.perf_counter() - t0:.1f} s on the host")

    counts.zero_launches()
    ret, out = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, packed,
                                                  packed=True)
    ladder_out = {kbps: viterbi_tpu_torch.deconvolve_batch(24 * kbps, s)
                  for kbps, (_, s) in ladder.items()}
    scalar_ret = viterbi_tpu_torch.deconvolve(FB_MAIN, syms[0])
    scalar_out = viterbi_tpu_torch.last_output()
    launches = {k: counts.launches()[k] for k in ("acs_regs", "tb_walk")}
    print(f"main path launches: {launches}")
    assert ret == 0 and scalar_ret == 0, (ret, scalar_ret)
    for name, count in launches.items():
        assert count > 0, f"the main path never launched {name}"

    assert out.shape == (B_MAIN, FB_MAIN // 8) and out.dtype == np.uint8
    expect8 = np.stack([golden.deconvolve(FB_MAIN, s) for s in syms[:8]])
    assert np.array_equal(out[:8], expect8), "main path != golden"
    assert np.array_equal(scalar_out, expect8[0]), "scalar != golden"
    ber, fer, nerr = channel.ber_fer(out, bits)
    print(f"main path: {B_MAIN} x {FB_MAIN} bits at {EBN0_DB} dB: "
          f"{nerr} bit errors, BER {ber:.3e}, FER {fer:.4f}")
    for kbps, (r, lout) in ladder_out.items():
        lbits, lsyms = ladder[kbps]
        assert r == 0, f"ladder {kbps} kbit/s returned {r}"
        lexp = np.stack([golden.deconvolve(24 * kbps, s)
                         for s in lsyms[:2]])
        assert np.array_equal(lout[:2], lexp), f"ladder {kbps} != golden"
        print(f"ladder {kbps:3d} kbit/s: B={B_CHECK}, "
              f"{channel.ber_fer(lout, lbits)[2]} bit errors")

    # the torch_scan rung on the card, same frames
    rung("torch_scan")
    t0 = time.perf_counter()
    ret0, out0 = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, packed,
                                                    packed=True)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    assert ret0 == 0 and np.array_equal(out0, out), \
        "cuda_fused != torch_scan on the main-path batch"
    print(f"main path bit-equal to torch_scan, kernel C + plain walk "
          f"(that rung took {scan_s:.2f} s end to end)")

    # --- phase 5: the words path through the public API -------------------
    t0 = time.perf_counter()
    words_launches = words_path(syms, packed, out, expect8)
    launches.update(words_launches)
    print(f"words path phase: {time.perf_counter() - t0:.1f} s")

    # --- phase 6: the harness ----------------------------------------------
    t0 = time.perf_counter()
    report = harness_phase(ROOT)
    print(f"{tag} harness: every rung {GATE['bit_errors']} bit errors / "
          f"{GATE['bad_frames']} bad frames in {GATE['frames']}, sweep "
          f"{SWEEP_ERRORS} equal to golden, fault injection PASS, tuner "
          f"chose {report['chosen_variant']} "
          f"({time.perf_counter() - t0:.1f} s)")

    # --- phase 7: times ----------------------------------------------------
    nsym = B_MAIN * C.RATE * (FB_MAIN + C.TAIL_BITS)
    e2e_ms = {}
    for name in ("cuda_fused", "cuda_words"):
        rung(name)
        e2e = []
        for _ in range(5):
            t0 = time.perf_counter()
            r, _ = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, packed,
                                                      packed=True)
            e2e.append(time.perf_counter() - t0)
            assert r == 0
        e2e_s = statistics.median(e2e)
        e2e_ms[name] = e2e_s * 1e3
        print(f"{tag} {name} deconvolve_batch(packed) B={B_MAIN} "
              f"framebits={FB_MAIN}: median {e2e_s * 1e3:.2f} ms end to "
              f"end over 5 calls, {nsym / e2e_s / 1e6:.1f} Msymbols/s")
    # the packed words go to the card as they are on every rung: an
    # unpack on the host took thirteen times the cuda_fused call
    assert e2e_ms["cuda_words"] < 3 * e2e_ms["cuda_fused"], \
        f"cuda_words packed {e2e_ms['cuda_words']:.1f} ms against " \
        f"cuda_fused {e2e_ms['cuda_fused']:.1f} ms: not the copy of the " \
        f"packed words"

    # each kernel against its plain version on the main-path batch: timed,
    # and the outputs of the untimed first runs held bit for bit
    n = FB_MAIN + C.TAIL_BITS
    ck = acs_cuda.DECODE_CKPT
    dsyms = torch.from_numpy(packed).to(dev)
    times = dict(ts_times)

    def timed(name, kernel, k_iters, plain, p_iters, parts):
        k_ms, got = cuda_ms(kernel, k_iters)
        p_ms, want = cuda_ms(plain, p_iters)
        for g, w, part in zip(got, want, parts, strict=True):
            check(name, g, w, f"B={B_MAIN} framebits={FB_MAIN} {part}")
        times[name] = (k_ms, p_ms)
        print(f"{tag} {name} at B={B_MAIN} framebits={FB_MAIN}: kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bit-identical")
        return got, want

    (regs, _), _ = timed(
        "acs_regs",
        lambda: acs_cuda.forward_regs(dsyms, n, ckpt=ck, packed="bt"), 10,
        lambda: acs_cuda.forward_regs_plain(dsyms, n, ckpt=ck, packed="bt"),
        1, ("regs", "metrics"))
    gap = n - (regs.shape[0] - 1) * ck
    one_frame = one_frame_times(dev, tag, check)

    def walk_plain():
        rs = tb.tb_walk_plain(regs, ck, gap)
        return rs, tb._regs_bytes(rs, FB_MAIN, ck, gap)

    # kernel B as the main path launches it: the walk with the bytes
    (rs_k, _), _ = timed(
        "tb_walk", lambda: tb.tb_walk_bytes(regs, FB_MAIN, ck, gap), 20,
        walk_plain, 3, ("windows", "bytes"))
    walk_extra = walk_times(tag, regs, rs_k, times["tb_walk"][0], ck, gap)
    del rs_k
    (dec, _), (dec_p, _) = timed(
        "acs_words", lambda: acs_cuda.forward(dsyms, n, packed="bt"), 10,
        lambda: acs_cuda.forward_plain(dsyms, n, packed="bt"), 1,
        ("decisions", "metrics"))
    _, (rs_p,) = timed("tb_words", lambda: (tb.tb_words(dec, FB_MAIN),), 20,
                       lambda: (tb.tb_words_plain(dec_p, FB_MAIN),), 3,
                       ("windows",))
    # the main path's output against a decode that runs no kernel at all
    assert np.array_equal(window_bytes(rs_p), out), \
        "main path != the plain decode (forward_plain + tb_words_plain)"
    print(f"main path bit-equal to the plain decode at B={B_MAIN} x "
          f"{FB_MAIN}")
    del regs, dec, dec_p
    lanes_at_main = {
        "acs_regs": acs_cuda._lanes(B_MAIN, acs_cuda.REGS_ONE_LANE_FRAMES,
                                    None, acs_cuda.REGS_WARP_FRAMES),
        "acs_words": acs_cuda._lanes(B_MAIN, acs_cuda.WORDS_ONE_LANE_FRAMES,
                                     None)}

    # the batch sweep of kernels A and C: the wrapper's choice and each
    # form by name; the choice must stay near the faster form
    from viterbi_tpu_torch.probes import kbatch
    t0 = time.perf_counter()
    table = kbatch.sweep(acs_cuda, FB_MAIN, iters=3)
    for batch, row in table["batch"].items():
        print(f"{tag} sweep B={batch} packed bt, ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in row.items()))
        for k in ("A", "C"):
            best = min(v for name, v in row.items() if name.startswith(k))
            assert row[k] < 1.3 * best + 0.05, \
                f"kernel {k} at B={batch}: the batch's choice {row[k]:.3f} " \
                f"ms against {best:.3f} ms for the faster form"
    for section in ("layouts", "blocks"):
        for key, row in table[section].items():
            print(f"{tag} sweep {key}, ms: A {row['A']:.3f}, C "
                  f"{row['C']:.3f}")
    print(f"{tag} SM clock while kernel A runs, MHz: {table['clock_mhz']} "
          f"(bounds use {clock_hz / 1e6:.0f})")
    print(f"batch sweep of kernels A and C: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # (the whole of kernel B's sweep, nine batches at three frame sizes,
    # old against new: probes/kbatch.py --what walk)
    walk_table = kbatch.sweep_walk(acs_cuda, tb, C, framebits=(FB_MAIN,),
                                   iters=10, batches=WALK_SWEEP)[FB_MAIN]
    for batch, row in walk_table.items():
        print(f"{tag} sweep B={batch} kernel B, ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()))
        best = min(v for name, v in row.items() if "segment" in name)
        assert row["B, graph"] < 1.3 * best + 0.002, \
            f"kernel B at B={batch}: the batch's choice " \
            f"{row['B, graph']:.4f} ms against {best:.4f} ms for the " \
            f"fastest form"
    print(f"batch sweep of kernel B: {time.perf_counter() - t0:.1f} s")

    # bounds of kernels A-D on the main-path batch: the bytes each must
    # move (B and D: what this run's walk reads) and its integer operations
    K = -(-n // ck)
    state_bytes = B_MAIN * 64 * 4
    bounds = {
        **ts_bounds,
        "acs_regs": bound(B_MAIN * n * 4 + (K + 2) * state_bytes,
                          B_MAIN * n * OPS_PER_STEP_A, clock_hz),
        # the registers it reads, the windows and the bytes it writes
        "tb_walk": bound(2 * K * B_MAIN * 4 + B_MAIN * FB_MAIN // 8,
                         K * B_MAIN * OPS_PER_CKPT_B
                         + B_MAIN * FB_MAIN // 8 * OPS_PER_BYTE_B, clock_hz),
        "acs_words": bound(B_MAIN * n * (4 + 8) + 2 * state_bytes,
                           B_MAIN * n * OPS_PER_STEP_C, clock_hz),
        "tb_words": bound(B_MAIN * n * 8 + B_MAIN * FB_MAIN // 24 * 4,
                          B_MAIN * FB_MAIN * OPS_PER_BIT_D, clock_hz),
    }

    # --- phases 8-11: the superframe chain, RS, EEP, replay -----------------
    rung("cuda_fused")
    t0 = time.perf_counter()
    sf_launches, sf, rs_row = superframe_path(dev, tag, check)
    print(f"superframe phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rs_paths = {"superframe": sf_launches, "rs_check_superframe":
                rs_export(tag, check), "rsform": rs_forms(tag)}
    frame_plan_times(tag)
    print(f"RS phase: {time.perf_counter() - t0:.1f} s")
    # kernel I's bound on the chain's superframes: each byte read once, the
    # audio and the two int32 sums written once; the operations this run's
    # codewords need (rs_decoder_ops): the syndromes on the tensor cores,
    # the dirty codewords on the integer lanes; the probe's table form
    # takes its syndromes on the integer lanes too
    mix = rs_row["mix"]
    rs_bytes = mix["codewords"] * (C.RS_N + C.RS_KK) \
        + mix["superframes"] * 8
    ops = mix["ops"]
    bounds["rs_decode"] = bound(rs_bytes, ops["dirty"], clock_hz,
                                tensor_ops=ops["synd_tensor"])
    bounds["rs_synd_table"] = bound(rs_bytes, ops["dirty"]
                                    + ops["synd_table"], clock_hz)
    times["rs_decode"] = (rs_row["ms"], rs_row["plain_ms"])
    times["rs_synd_table"] = (rs_row["table_ms"], rs_row["plain_ms"])
    t0 = time.perf_counter()
    eep_launches, j_row = eep_path(dev, tag, check)
    times["depuncture"] = (j_row["ms"], j_row["plain_ms"])
    # kernel J's bound: the kept bytes read and the mother-code bytes
    # written once; its integer operations a step
    bounds["depuncture"] = bound(j_row["bytes"],
                                 j_row["steps"] * OPS_PER_STEP_J, clock_hz)
    tdmb_launches = tdmb_path(dev, tag)
    replay_phase(ROOT)
    print(f"EEP and replay phases: {time.perf_counter() - t0:.1f} s; "
          f"launches on the superframe path {sf_launches}, on the EEP path "
          f"{eep_launches}")

    # --- phase 12: the probes -------------------------------------------------
    t0 = time.perf_counter()
    probe_rows = probes_phase(dev, tag, check, clock_hz)
    print(f"probes phase: {time.perf_counter() - t0:.1f} s")

    # --- phases 13-16: tail-biting, streaming, sessions, host ingest ---------
    fused_gsym = nsym / (times["acs_regs"][0] + times["tb_walk"][0]) / 1e6
    paths = {"main": launches, "eep": eep_launches, "tdmb": tdmb_launches,
             **rs_paths}
    t_new = time.perf_counter()
    for name, phase in (
            ("tailbiting", lambda: tailbiting_phase(dev, tag, check)),
            ("streaming", lambda: streaming_phase(dev, tag, check,
                                                  fused_gsym)),
            ("session", lambda: session_phase(dev, tag, check)),
            ("ingest", lambda: ingest_phase(dev, tag, packed))):
        t0 = time.perf_counter()
        paths[name] = phase()
        torch.cuda.synchronize()
        print(f"{name} phase: {time.perf_counter() - t0:.1f} s")
    print(f"phases 13-16: {time.perf_counter() - t_new:.1f} s")

    # --- phase 17: several processes on one card ------------------------------
    t0 = time.perf_counter()
    several = several_phase(dev, tag, syms, out, expect8, sf)
    del sf
    paths.update(several["launches"])
    for name, e in several["errs"].items():
        errs[name] = max(errs[name], e)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # --- phase 18: the entry points and the evidence tools -------------------
    t0 = time.perf_counter()
    rung("cuda_fused")
    paths.update(tools_phase(dev, tag))
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # --- phase 19: first use in a fresh process ----------------------------
    t0 = time.perf_counter()
    paths["first_use"] = first_use_phase(tag)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")

    csrc = "viterbi_tpu_torch/csrc/"
    meta = {
        "acs_regs": (csrc + "acs_regs.cu",
                     "viterbi_tpu/ops/acs_pallas.py:463"),
        "tb_walk": (csrc + "tb_walk.cu", "viterbi_tpu/ops/traceback.py:206"),
        "acs_words": (csrc + "acs_words.cu",
                      "viterbi_tpu/ops/acs_pallas.py:830"),
        "tb_words": (csrc + "tb_words.cu",
                     "viterbi_tpu/ops/traceback.py:374"),
        "kablate": (csrc + "probes/kablate.cu", "scripts/kablate.py:68"),
        "kdtype_op": (csrc + "probes/kdtype.cu", "scripts/kdtype.py:27"),
        "kdtype_chain": (csrc + "probes/kdtype.cu", "scripts/kdtype.py:60"),
        "kilp_streams": (csrc + "probes/kilp.cu", "scripts/kilp.py:30"),
        # jitted XLA functions, not Pallas kernels: rs_decode_blocks and
        # rs_check_superframe (rs.py:300); the probe is kernel I's device
        # code with the other syndrome form
        "rs_decode": (csrc + "rs_decode.cu", "viterbi_tpu/ops/rs.py:166"),
        "rs_synd_table": (csrc + "probes/rs_synd.cu",
                          "viterbi_tpu/ops/rs.py:166"),
        # no Pallas kernel: the JAX package's XLA scatter
        "depuncture": (csrc + "depuncture.cu",
                       "viterbi_tpu/models/dab.py depuncture_device"),
        # no T-DMB chain in the JAX package
        "deinterleave": (csrc + "deinterleave.cu", None),
        "rs_packets": (csrc + "rs_decode.cu", None),
    }
    # kernel I's row counts both its entries
    i_paths = {path: c.get("rs_decode", 0) + c.get("rs_superframes", 0)
               for path, c in paths.items()}
    kernels = []
    for name, (src, rep) in meta.items():
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep}
        if name in probe_rows:
            row.update(probe_rows[name])
        elif name == "rs_synd_table":
            # a probe: its launches a call on the rsform path; its time on
            # phase 8's superframes, beside kernel I's
            row.update(launches=rs_paths["rsform"][name], ms=times[name][0],
                       plain_ms=times[name][1], library_ms=None,
                       **bounds[name])
        else:
            # no single PyTorch call computes kernels A-D or I-K; kernel
            # I's launches are the superframe chain's (phase 8), kernel
            # J's the EEP path's (phase 10), K's and I's packets entry's
            # the T-DMB chain's (phase 10)
            by_path = i_paths if name == "rs_decode" else {
                path: c.get(name, 0) for path, c in paths.items()}
            row.update(launches=by_path[{
                "rs_decode": "superframe", "depuncture": "eep",
                "deinterleave": "tdmb", "rs_packets": "tdmb"}.get(name,
                                                                  "main")],
                       ms=times[name][0], plain_ms=times[name][1],
                       library_ms=None, **bounds[name])
            if name in lanes_at_main:     # the form taken at this batch
                row["lanes"] = lanes_at_main[name]
            if name == "acs_regs":
                row["one_frame"] = one_frame
            if name == "tb_walk":
                row.update(walk_extra)
            # the launches of each path's call (the session: a push)
            row["launches_by_path"] = {p: n for p, n in by_path.items()
                                       if n}
        row["max_abs_err"] = errs[name]
        assert row["launches"] > 0 and row["max_abs_err"] == 0, row
        kernels.append(row)
        print(f"{tag} {name}: {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({100 * row['bound_ms'] / row['ms']:.1f} %; bytes "
              f"{row['bound_bytes_ms']:.4f} ms, operations "
              f"{row['bound_ops_ms']:.4f} ms), plain "
              f"{row['plain_ms']:.3f} ms, library {row['library_ms']}, "
              f"{row['launches']} launches on its path")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
