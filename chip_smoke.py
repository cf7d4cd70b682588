#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main decode path once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):
  1. device: require a CUDA device; print the card's name and power limit;
  2. build: compile the kernels from viterbi_tpu_torch/csrc with nvcc;
  3. kernels: kernel A (fused register-exchange ACS) and kernel B
     (checkpoint walk), kernel C (decisions) and kernel D (decision-word
     walk) against their plain torch versions on the card, bit for bit,
     over the frame sizes, layouts and anchors the decode paths can hand
     them;
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
     version on the main-path batch, timed and held bit for bit; and
     the main path's output against a decode through plain versions
     only (forward_plain, then tb_words_plain).
The last line of output is {"ok": true, "device": {...}}; the line
before it lists the kernels as JSON.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
                what = f"framebits {fb}, packed={packed}, init={with_init}"
                d_k, m_k = acs_cuda.forward(torch.from_numpy(host).to(dev),
                                            n, init, packed=packed)
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
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # --- phase 3: kernels vs plain versions ------------------------------
    rng = np.random.default_rng(2024)
    errs = {"acs_regs": 0, "tb_walk": 0, "acs_words": 0, "tb_words": 0}

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
        r_k, m_k = acs_cuda.forward_regs(syms, n, **kw)
        r_p, m_p = acs_cuda.forward_regs_plain(syms, n, **kw)
        check("acs_regs", r_k, r_p, what + " regs")
        check("acs_regs", m_k, m_p, what + " metrics")
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
    print(f"kernels A, B vs plain: {len(cases)} shapes bit-identical "
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

    meta = {
        "acs_regs": ("viterbi_tpu_torch/csrc/acs_regs.cu",
                     "viterbi_tpu/ops/acs_pallas.py:463"),
        "tb_walk": ("viterbi_tpu_torch/csrc/tb_walk.cu",
                    "viterbi_tpu/ops/traceback.py:206"),
        "acs_words": ("viterbi_tpu_torch/csrc/acs_words.cu",
                      "viterbi_tpu/ops/acs_pallas.py:830"),
        "tb_words": ("viterbi_tpu_torch/csrc/tb_words.cu",
                     "viterbi_tpu/ops/traceback.py:374"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name, (src, rep) in meta.items()]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
