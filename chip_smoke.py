#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's decode paths once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):
  1. device: require a CUDA device; print the card's name and power limit;
  2. build: compile the decode kernels and the probes' kernels from
     viterbi_tpu_torch/csrc with nvcc, both libraries at the same time;
     kernels A, C and E, in both forms (one lane a frame and four), must
     spill nothing;
  3. kernels: kernel A (fused register-exchange ACS) and kernel B
     (checkpoint walk), kernel C (decisions) and kernel D (decision-word
     walk) against their plain torch versions on the card, bit for bit,
     over the frame sizes, layouts and anchors the decode paths can hand
     them; A and C in the form the batch selects and in each form by
     name, also at batches that leave the last warp ragged, with a reset
     inside a six-step window and at every checkpoint period;
  4. main path: initialize() must pick the cuda_fused rung; decode
     B=16384 noisy frames of 3072 bits through
     deconvolve_batch(packed=True), bit-equal to the golden model and
     to the torch_scan rung (kernel C and the plain serial walk), then
     the DAB bitrate ladder and one scalar deconvolve; kernels A and B
     must be launched;
  5. words path: with the override at 2, initialize() must pick the
     cuda_words rung; the same frames, unpacked and packed, bit-equal to
     the cuda_fused output and to golden; framebits 64 through the
     blocked fallback; kernels C and D must be launched; then the
     torch_blocked rung on the same frames;
  6. harness: viterbi_tpu_torch.harness.benchmark at /f 5000 /t 10 on
     all four rungs: every rung must decode 2637 bit errors in 595 bad
     frames, the Eb/N0 sweep 1321 / 55 / 11 errors equal to golden, and
     fault injection must pass;
  7. times: both paths end to end; each kernel against its plain
     version on the main-path batch, timed and held bit for bit; the
     main path's output against a decode through plain versions only
     (forward_plain, then tb_words_plain); and the batch sweep of
     kernels A and C in both forms (probes.kbatch);
  8. superframe path: 2048 DAB+ audio superframes at 128 kbit/s (10240
     frames, 32768 RS codewords) through
     models.dab.decode_audio_superframes on the card: kernels A and B
     must be launched, the audio equal to what was encoded wherever the
     error count is not -1, audio and counts equal to the golden model
     and to the CPU's plain path on subsets, and on the whole batch to
     the same call through plain versions only on the card; kernels A
     and B against their plain versions on the path's own symbols; rates
     and the split Viterbi / assembly / RS;
  9. RS: rs_check_superframe through the API for rs_dims 1, 4, 16, 48,
     clean, corrected and -1 with the partial prefix write, against
     golden; then probes.rsform: the table and the bitwise form of the
     field arithmetic at 65536 codewords on three error mixes, equal to
     each other and timed;
 10. EEP path: decode_punctured_frames at 128 kbit/s for EEP 3-A and
     2-B, and decode_profile_frames with a four-segment row, against
     golden on a subset and, on the whole batch, against the plain path
     on the card; kernels A and B against their plain versions on the
     depunctured symbols;
 11. replay: the committed corpus replays bit-exactly;
 12. probes: kernels E to H against their plain versions, bit for bit,
     at the probes' own shapes, then each probe's table.
The last line of output is {"ok": true, "device": {...}}; the line
before it lists the eight kernels as JSON, each with its launches on its
path, its time beside its plain version's, and its bound: the larger of
the bytes it must move over 3.35 TB/s and its integer operations (the
shortest sequence that computes the step; an add feeding a min counts as
one, as the card fuses them) over the card's issue rate.
"""

from __future__ import annotations

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

# The card's peaks for the bounds: memory rate (data sheet), and issue
# rates per SM and clock: 64 int32 lanes, 128 float32 lanes (an add or a
# min is one operation; the 67 TFLOP/s of the data sheet count an FMA
# as two).
HBM_BYTES_S = 3.35e12
SMS = 132
INT_LANES, FP32_LANES = 64, 128
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
OPS_PER_BIT_D = 9       # word select, 2 shifts + 2 masks, 2 to place, 2 state


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
          fp_ops: float = 0.0) -> dict:
    """The least time the card could take, as a kernel row's bound keys:
    ``bound_ms`` is the larger of the bytes over the memory rate
    (``bound_bytes_ms``) and the operations over the issue rate of their
    type, integer and float pipes side by side (``bound_ops_ms``);
    ``bound_by`` says which."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_S
    by_ops = 1e3 * max(int_ops / (INT_LANES * SMS * clock_hz),
                       fp_ops / (FP32_LANES * SMS * clock_hz))
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
    return int((got.long() - want.long()).abs().max().item())


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
    for lanes in FORMS:
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
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import traceback as tb
    rung("cuda_words")
    bits64, syms64 = channel.make_frames(B_CHECK, 64, seed=64)
    for counter in (acs_cuda.forward, tb.tb_words, acs_cuda.forward_regs,
                    tb.tb_walk):
        counter.launches = 0
    ret_u, out_u = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, syms)
    ret_p, out_p = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, packed,
                                                      packed=True)
    ret_64, out_64 = viterbi_tpu_torch.deconvolve_batch(64, syms64)
    launches = {"acs_words": acs_cuda.forward.launches,
                "tb_words": tb.tb_words.launches}
    print(f"words path launches: {launches}")
    assert (ret_u, ret_p, ret_64) == (0, 0, 0), (ret_u, ret_p, ret_64)
    for name, count in launches.items():
        assert count > 0, f"the words path never launched {name}"
    assert acs_cuda.forward_regs.launches == tb.tb_walk.launches == 0, \
        "the words path ran the fused kernels"
    assert np.array_equal(out_u, out), "cuda_words (unpacked) != cuda_fused"
    assert np.array_equal(out_p, out), "cuda_words (packed) != cuda_fused"
    assert np.array_equal(out_u[:8], expect8), "cuda_words != golden"
    assert np.array_equal(out_64, golden.deconvolve_many(64, syms64)), \
        "cuda_words at framebits 64 (blocked fallback) != golden"
    print(f"words path: B={B_MAIN} x {FB_MAIN} unpacked and packed "
          f"bit-equal to cuda_fused and golden; framebits 64 (blocked "
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
    for lanes in reversed(FORMS):       # the path's own form last
        r_k, m_k = acs_cuda.forward_regs(flat, n, ckpt=ck, lanes=lanes)
        check("acs_regs", r_k, r_p, f"{what}, lanes={lanes} regs")
        check("acs_regs", m_k, m_p, f"{what}, lanes={lanes} metrics")
    gap = n - (r_k.shape[0] - 1) * ck
    check("tb_walk", tb.tb_walk(r_k, ck, gap), tb.tb_walk_plain(r_k, ck, gap),
          what + " windows")


def superframe_path(dev, tag, check) -> dict:
    """Phase 8: the DAB+ audio-superframe chain at full width on the
    card; returns kernel A's and B's launch counts on the path."""
    import torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch import golden
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.models import dab
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import rs as rs_ops
    from viterbi_tpu_torch.ops import traceback as tb
    from viterbi_tpu_torch.probes import _common
    cfg = dab.SubchannelConfig(SF_KBPS)
    t0 = time.perf_counter()
    audio, syms = channel.make_superframes(B_SF, SF_KBPS, seed=11,
                                           ebn0_db=EBN0_DB,
                                           uncorrectable=SF_BAD)
    print(f"superframes: {B_SF} x 5 frames of {cfg.framebits} bits, "
          f"{B_SF * cfg.rs_dims} codewords, {syms.nbytes / 1e6:.0f} MB of "
          f"symbols, made in {time.perf_counter() - t0:.1f} s on the host")
    acs_cuda.forward_regs.launches = 0
    tb.tb_walk.launches = 0
    got_audio, got_errors = dab.decode_audio_superframes(syms, SF_KBPS)
    torch.cuda.synchronize()
    launches = {"acs_regs": acs_cuda.forward_regs.launches,
                "tb_walk": tb.tb_walk.launches}
    print(f"superframe path launches: {launches}")
    for name, count in launches.items():
        assert count > 0, f"the superframe path never launched {name}"
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
    asm_ms, blocks = cuda_ms(lambda: dab.bytes_to_superframes(
        frame_bytes.reshape(B_SF, dab.SUPERFRAME_FRAMES, cfg.frame_bytes),
        cfg).reshape(B_SF, C.RS_N, cfg.rs_dims).transpose(1, 2)
        .reshape(B_SF * cfg.rs_dims, C.RS_N).contiguous(), 5)
    rs_ms, _ = cuda_ms(lambda: rs_ops.rs_decode_blocks(blocks), 5)
    rs_launches = _common.count_launches(
        lambda: rs_ops.rs_decode_blocks(blocks))
    print(f"{tag} superframe path B={B_SF} at {SF_KBPS} kbit/s: "
          f"{B_SF / e2e_s:.1f} superframes/s end to end (median "
          f"{e2e_s * 1e3:.2f} ms of 3), {B_SF / res_ms * 1e3:.1f} "
          f"superframes/s with the symbols resident ({res_ms:.2f} ms); "
          f"split Viterbi {vit_ms:.2f} ms, assembly {asm_ms:.2f} ms, RS "
          f"{rs_ms:.2f} ms in {rs_launches} launches")
    return launches


def rs_export(tag) -> None:
    """Phase 9a: rs_check_superframe through the API against golden."""
    import viterbi_tpu_torch
    from viterbi_tpu_torch import constants as C
    from viterbi_tpu_torch import golden
    rung("cuda_fused")
    rng = np.random.default_rng(9)
    for rs_dims in (1, 4, 16, 48):
        cases = {"clean": [0] * rs_dims,
                 "corrected": [(3 * j) % 6 for j in range(rs_dims)],
                 "uncorrectable": [(j + 1) % 4 if j != rs_dims // 2 else 9
                                   for j in range(rs_dims)]}
        times = {}
        for case, errs in cases.items():
            cws = golden.rs_encode_many(rng.integers(
                0, 256, (rs_dims, C.RS_KK), dtype=np.uint8))
            for j, e in enumerate(errs):
                pos = rng.choice(C.RS_N, e, replace=False)
                cws[j, pos] ^= rng.integers(1, 256, e).astype(np.uint8)
            sf = cws.T.reshape(-1)
            g_err, g_out = golden.rs_check_superframe(sf, rs_dims)
            buf = bytearray([0xEE] * (rs_dims * C.RS_KK))
            runs = []
            for _ in range(5):
                buf[:] = bytes([0xEE]) * len(buf)
                t0 = time.perf_counter()
                ret = viterbi_tpu_torch.rs_check_superframe(sf, 0, rs_dims,
                                                            buf)
                runs.append(time.perf_counter() - t0)
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
        print(f"{tag} rs_check_superframe rs_dims={rs_dims}: clean, "
              f"corrected and -1 (prefix of {rs_dims // 2}) equal to golden; "
              + ", ".join(f"{c} {ms:.2f} ms" for c, ms in times.items())
              + " per call")


def rs_forms(tag) -> None:
    """Phase 9b: the table form and the bitwise form of the field
    arithmetic on three error mixes (probes.rsform, which raises unless
    they are equal, count as planted and agree with golden)."""
    from viterbi_tpu_torch.probes import rsform
    rows = rsform.main([])
    assert len(rows) == 2 * len(rsform.MIXES)
    for r in rows:
        assert r["ms"] > 0 and r["launches"], r
    print(f"{tag} RS forms: " + "; ".join(
        f"{r['mix']} {r['form']} {r['ms']:.2f} ms in {r['launches']} launches"
        for r in rows))


def eep_path(dev, tag, check) -> dict:
    """Phase 10: the punctured-frame decoders on the card."""
    import torch
    from viterbi_tpu_torch import golden
    from viterbi_tpu_torch.harness import channel
    from viterbi_tpu_torch.models import dab
    from viterbi_tpu_torch.models import puncture as P
    from viterbi_tpu_torch.ops import acs_cuda
    from viterbi_tpu_torch.ops import traceback as tb
    fb = 24 * SF_KBPS
    launches = {"acs_regs": 0, "tb_walk": 0}
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

        acs_cuda.forward_regs.launches = 0
        tb.tb_walk.launches = 0
        t0 = time.perf_counter()
        got = decode(rec)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches["acs_regs"] += acs_cuda.forward_regs.launches
        launches["tb_walk"] += tb.tb_walk.launches
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
              f"kernels A and B bit-identical to plain on its symbols "
              f"({ms:.1f} ms end to end)")
    for name, count in launches.items():
        assert count == len(profiles), f"EEP path: {name} x {count}"
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
    # the row: u8 add, beside the one PyTorch call that computes it
    x, y = (torch.from_numpy(rng.integers(0, 256, kdtype.OP_SHAPE)
                             .astype(np.int32)).to(dev) for _ in range(2))
    a8, b8 = x.to(torch.uint8), y.to(torch.uint8)
    out8 = torch.empty_like(a8)
    codes = kdtype._op_codes("add", "u8")
    nlanes = x.numel()
    # ms: the launch alone on operands stored as u8, as the library call
    # has them; wrapper_ms: with the wrapper's conversions from and to
    # int32 lane values
    rows["kdtype_op"] = dict(
        ms=cuda_ms(lambda: kdtype._launch_op(codes, a8, b8, out8), 50)[0],
        wrapper_ms=cuda_ms(
            lambda: kdtype.elementwise("add", "u8", x, y), 50)[0],
        plain_ms=cuda_ms(
            lambda: kdtype.elementwise_plain("add", "u8", x, y), 50)[0],
        library_ms=cuda_ms(lambda: torch.add(a8, b8), 50)[0],
        **bound(3 * nlanes, nlanes, clock_hz))
    check("kdtype_op", out8, torch.add(a8, b8), "u8 add on stored operands")
    print(f"kernel F vs plain: {len(kdtype.OP_DTYPES) * len(kdtype.OPS)} "
          f"narrow and {len(kdtype.PACKED_OPS)} packed ops on "
          f"{kdtype.OP_SHAPE} bit-identical "
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
    counters = {"kablate": kablate.forward_regs_ablated,
                "kdtype_op": kdtype.elementwise,
                "kdtype_chain": kdtype.chain, "kilp_streams": kilp.streams}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    abl_ms = kablate.main(["--iters", "10"])
    abl_one_ms = kablate.main(["--iters", "10", "--lanes", "1"])
    dt = kdtype.main([])
    ilp = kilp.main([])
    for name, fn in counters.items():
        assert fn.launches > 0, f"the probes never launched {name}"
        rows[name]["launches"] = fn.launches
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
    from viterbi_tpu_torch.ops import _build, acs_cuda
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
            if lib is _build.MAIN or "kablate" in name:
                print(f"  ptxas: {name}: {regs} registers, spills {st} B "
                      f"stored, {ld} B loaded")
    # kernels A, C and E: one lane a frame and four, packed and unpacked
    # symbols (E: six variants, packed); none may spill
    forward = {n: v for lib in (_build.MAIN, _build.PROBES)
               for n, v in ptxas_summary(_build.build_log(library=lib)).items()
               if any(k in n for k in ("acs_regs_kernel", "acs_words_kernel",
                                       "kablate_kernel"))}
    for kernel, count in (("acs_regs_kernel", 4), ("acs_words_kernel", 4),
                          ("kablate_kernel", 12)):
        names = [n for n in forward if kernel in n]
        assert len(names) == count, f"{kernel}'s instantiations: {names}"
    for name, (regs, st, ld) in forward.items():
        assert st == 0 and ld == 0, f"{name} spills: {st}/{ld} bytes"
    clock_hz = sm_clock_hz()
    print(f"bounds against {HBM_BYTES_S / 1e12} TB/s and "
          f"{INT_LANES * SMS * clock_hz / 1e12:.2f} T int32 ops/s "
          f"({SMS} SMs x {INT_LANES} lanes x {clock_hz / 1e6:.0f} MHz)")

    # --- phase 3: kernels vs plain versions ------------------------------
    rng = np.random.default_rng(2024)
    errs = dict.fromkeys(("acs_regs", "tb_walk", "acs_words", "tb_words",
                          "kablate", "kdtype_op", "kdtype_chain",
                          "kilp_streams"), 0)

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
        for lanes in FORMS:
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

    acs_cuda.forward_regs.launches = 0
    tb.tb_walk.launches = 0
    ret, out = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, packed,
                                                  packed=True)
    ladder_out = {kbps: viterbi_tpu_torch.deconvolve_batch(24 * kbps, s)
                  for kbps, (_, s) in ladder.items()}
    scalar_ret = viterbi_tpu_torch.deconvolve(FB_MAIN, syms[0])
    scalar_out = viterbi_tpu_torch.last_output()
    launches = {"acs_regs": acs_cuda.forward_regs.launches,
                "tb_walk": tb.tb_walk.launches}
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
        print(f"{tag} {name} deconvolve_batch(packed) B={B_MAIN} "
              f"framebits={FB_MAIN}: median {e2e_s * 1e3:.2f} ms end to "
              f"end over 5 calls, {nsym / e2e_s / 1e6:.1f} Msymbols/s")

    # each kernel against its plain version on the main-path batch: timed,
    # and the outputs of the untimed first runs held bit for bit
    n = FB_MAIN + C.TAIL_BITS
    ck = acs_cuda.DECODE_CKPT
    dsyms = torch.from_numpy(packed).to(dev)
    times = {}

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
    timed("tb_walk", lambda: (tb.tb_walk(regs, ck, gap),), 20,
          lambda: (tb.tb_walk_plain(regs, ck, gap),), 3, ("windows",))
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
                                    None),
        "acs_words": acs_cuda._lanes(B_MAIN, acs_cuda.WORDS_ONE_LANE_FRAMES,
                                     None)}

    # the batch sweep of kernels A and C: the wrapper's choice and each
    # form by name; the choice must stay near the faster form
    from viterbi_tpu_torch.probes import kbatch
    t0 = time.perf_counter()
    table = kbatch.sweep(acs_cuda, FB_MAIN, iters=5)
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
    print(f"batch sweep: {time.perf_counter() - t0:.1f} s")

    # bounds of kernels A-D on the main-path batch: the bytes each must
    # move (B and D: what this run's walk reads) and its integer operations
    K = -(-n // ck)
    state_bytes = B_MAIN * 64 * 4
    bounds = {
        "acs_regs": bound(B_MAIN * n * 4 + (K + 2) * state_bytes,
                          B_MAIN * n * OPS_PER_STEP_A, clock_hz),
        "tb_walk": bound(2 * K * B_MAIN * 4, K * B_MAIN * OPS_PER_CKPT_B,
                         clock_hz),
        "acs_words": bound(B_MAIN * n * (4 + 8) + 2 * state_bytes,
                           B_MAIN * n * OPS_PER_STEP_C, clock_hz),
        "tb_words": bound(B_MAIN * n * 8 + B_MAIN * FB_MAIN // 24 * 4,
                          B_MAIN * FB_MAIN * OPS_PER_BIT_D, clock_hz),
    }

    # --- phases 8-11: the superframe chain, RS, EEP, replay -----------------
    rung("cuda_fused")
    t0 = time.perf_counter()
    sf_launches = superframe_path(dev, tag, check)
    print(f"superframe phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rs_export(tag)
    rs_forms(tag)
    print(f"RS phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eep_launches = eep_path(dev, tag, check)
    replay_phase(ROOT)
    print(f"EEP and replay phases: {time.perf_counter() - t0:.1f} s; "
          f"launches on the superframe path {sf_launches}, on the EEP path "
          f"{eep_launches}")

    # --- phase 12: the probes -------------------------------------------------
    t0 = time.perf_counter()
    probe_rows = probes_phase(dev, tag, check, clock_hz)
    print(f"probes phase: {time.perf_counter() - t0:.1f} s")

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
    }
    kernels = []
    for name, (src, rep) in meta.items():
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep}
        if name in probe_rows:
            row.update(probe_rows[name])
        else:
            # no single PyTorch call computes kernels A-D
            row.update(launches=launches[name], ms=times[name][0],
                       plain_ms=times[name][1], library_ms=None,
                       **bounds[name])
            if name in lanes_at_main:     # the form taken at this batch
                row["lanes"] = lanes_at_main[name]
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
