#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main decode path once on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):
  1. device: require a CUDA device; print the card's name and power limit;
  2. build: compile the kernels from viterbi_tpu_torch/csrc with nvcc;
  3. kernels: kernel A (fused register-exchange ACS) and kernel B
     (checkpoint walk) against their plain torch versions on the card,
     bit for bit, over the frame sizes, layouts and anchors the decode
     path can hand them;
  4. main path: initialize() must pick the cuda_fused rung; decode
     B=16384 noisy frames of 3072 bits through
     deconvolve_batch(packed=True), bit-equal to the torch_scan rung on
     the card and to the golden model, then the DAB bitrate ladder and
     one scalar deconvolve; both kernels' launch counts must move;
  5. times: the main-path call end to end, and each kernel against its
     plain version at the main-path shape.
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


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    errs = {"acs_regs": 0, "tb_walk": 0}

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
    print(f"kernels vs plain: {len(cases)} shapes bit-identical "
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
    config_mod.write_variant(0)
    viterbi_tpu_torch.initialize()
    assert dispatch.VARIANTS[dispatch.state().variant] == "torch_scan"
    t0 = time.perf_counter()
    ret0, out0 = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, packed,
                                                    packed=True)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    assert ret0 == 0 and np.array_equal(out0, out), \
        "cuda_fused != torch_scan on the main-path batch"
    config_mod.write_variant(-1)
    viterbi_tpu_torch.initialize()
    assert dispatch.VARIANTS[dispatch.state().variant] == "cuda_fused"
    print(f"main path bit-equal to torch_scan (that rung took "
          f"{scan_s:.2f} s end to end)")

    # --- phase 5: times ----------------------------------------------------
    nsym = B_MAIN * C.RATE * (FB_MAIN + C.TAIL_BITS)
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        r, _ = viterbi_tpu_torch.deconvolve_batch(FB_MAIN, packed,
                                                  packed=True)
        e2e.append(time.perf_counter() - t0)
        assert r == 0
    e2e_s = statistics.median(e2e)
    print(f"{tag} main path deconvolve_batch(packed) B={B_MAIN} "
          f"framebits={FB_MAIN}: median {e2e_s * 1e3:.2f} ms end to end "
          f"over 5 calls, {nsym / e2e_s / 1e6:.1f} Msymbols/s")

    n = FB_MAIN + C.TAIL_BITS
    dsyms = torch.from_numpy(packed).to(dev)
    regs, _ = acs_cuda.forward_regs(dsyms, n, ckpt=acs_cuda.DECODE_CKPT,
                                    packed="bt")
    K = regs.shape[0]
    gap = n - (K - 1) * acs_cuda.DECODE_CKPT
    times = {
        "acs_regs": (
            cuda_ms(lambda: acs_cuda.forward_regs(
                dsyms, n, ckpt=acs_cuda.DECODE_CKPT, packed="bt"), 10),
            cuda_ms(lambda: acs_cuda.forward_regs_plain(
                dsyms, n, ckpt=acs_cuda.DECODE_CKPT, packed="bt"), 1)),
        "tb_walk": (
            cuda_ms(lambda: tb.tb_walk(regs, acs_cuda.DECODE_CKPT, gap), 20),
            cuda_ms(lambda: tb.tb_walk_plain(regs, acs_cuda.DECODE_CKPT,
                                             gap), 3)),
    }
    for name, (k_ms, p_ms) in times.items():
        print(f"{tag} {name} at B={B_MAIN} framebits={FB_MAIN}: kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms")

    meta = {
        "acs_regs": ("viterbi_tpu_torch/csrc/acs_regs.cu",
                     "viterbi_tpu/ops/acs_pallas.py:463"),
        "tb_walk": ("viterbi_tpu_torch/csrc/tb_walk.cu",
                    "viterbi_tpu/ops/traceback.py:206"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
