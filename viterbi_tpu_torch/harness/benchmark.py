"""Test & benchmark program — the twin of viterbi-benchmark.exe
(viterbi-benchmark/viterbi-benchmark.cpp) and of
``viterbi_tpu.harness.benchmark``: checks every decoder variant on this
backend, measures BER/FER at the reference operating point and decode
speed per DAB bitrate, auto-tunes the config file to the fastest
variant, and fault-injects the recovery subsystem.

CLI (flags mirror the reference, dashes also accepted):
    python -m viterbi_tpu_torch.harness.benchmark [/f frames] [/t loops]
                                                  [/not] [/json PATH]
      /f    warm-up+BER frames, 100..25000 (default 500)
      /t    timed decode loops (default 100)
      /not  skip the fault-injection ("exception") tests
      /json write the machine-readable report

The exit code is 0 only when every variant agrees on the BER/FER counts,
every variant's device-resident run succeeds (on a card), the Eb/N0
sweep equals the golden model and fault injection passes.
"""

from __future__ import annotations

import json
import sys
import time
from collections import Counter

import numpy as np
import torch

from .. import api, golden
from .. import constants as C
from ..runtime import config as config_mod
from ..runtime import dispatch
from . import channel

GATE_FRAMEBITS = 3072        # framebits of the BER/FER gate and the sweep
SPEED_BATCH = 256            # frames per timed API call
SPEED_BITRATES = (32, 64, 96, 128, 384)
DEVICE_BATCH = 16384         # frames per device-resident call
SWEEP_FRAMES = 192


def _supported_variants() -> list[int]:
    caps = dispatch.state().caps
    return [i for i in range(4) if dispatch._variant_supported(i, caps)]


def _on_card() -> bool:
    return bool(dispatch.state().caps & dispatch.CAP_CUDA)


def select_variant(variant: int) -> None:
    """Select a rung through the config file, as the tuner persists one;
    raises if the backend does not offer it."""
    config_mod.write_variant(variant)
    api.initialize()
    got = dispatch.state().variant
    if got != variant:
        raise RuntimeError(f"variant {dispatch.VARIANTS[variant]} is not "
                           f"supported here (got {dispatch.VARIANTS[got]})")


def ber_fer_test(variant: int, nframes: int, framebits: int = GATE_FRAMEBITS,
                 batch: int = 64, seed: int = 0):
    """BER/FER at Eb/N0 = 3 dB with identical noise for every variant
    (the reference reseeds srandom(0) per ISA, :302,374): batch i of
    ``batch`` frames is drawn from seed ``seed + i*batch``. Returns
    (ber, fer, bit errors, bad frames)."""
    select_variant(variant)
    tot_errs = badframes = done = 0
    while done < nframes:
        n = min(batch, nframes - done)
        bits, syms = channel.make_frames(n, framebits, seed=seed + done)
        ret, out = api.deconvolve_batch(framebits, syms)
        if ret != 0:
            raise RuntimeError(f"deconvolve_batch returned {ret}")
        per_frame = np.unpackbits(out ^ np.packbits(bits, axis=1),
                                  axis=1).sum(axis=1)
        tot_errs += int(per_frame.sum())
        badframes += int(np.count_nonzero(per_frame))
        done += n
    return (tot_errs / (nframes * framebits), badframes / nframes, tot_errs,
            badframes)


def ebno_sweep(points=(2.0, 3.0, 4.0), frames: int = SWEEP_FRAMES,
               framebits: int = GATE_FRAMEBITS, seed: int = 77) -> dict:
    """Golden-vs-production absolute BER anchor: cross-variant equality
    cannot catch a drift shared by every variant, so at each Eb/N0 point
    the selected variant's output must equal the golden model's on
    identical noise. Returns {"points": {...}, "ok": bool}."""
    out = {"frames": frames, "framebits": framebits, "points": {},
           "ok": True}
    for ebno in points:
        bits, syms = channel.make_frames(frames, framebits, seed=seed,
                                         ebn0_db=ebno)
        ret, got = api.deconvolve_batch(framebits, syms)
        if ret != 0:
            raise RuntimeError(f"deconvolve_batch returned {ret}")
        gold = golden.deconvolve_many(framebits, syms)
        errs = channel.ber_fer(got, bits)[2]
        gerrs = channel.ber_fer(gold, bits)[2]
        match = bool(np.array_equal(got, gold))
        out["points"][str(ebno)] = {
            "bit_errors": errs, "golden_bit_errors": gerrs,
            "bitwise_equal": match}
        out["ok"] &= match and errs == gerrs
    return out


def speed_test(variant: int, loops: int, batch: int = SPEED_BATCH,
               bitrates=SPEED_BITRATES) -> dict:
    """Timed batched decode through the public API per DAB bitrate
    (framebits = bitrate*24): host symbols in, host bytes out, so every
    call includes its transfers. Returns {bitrate: seconds_per_loop}."""
    select_variant(variant)
    results = {}
    rng = np.random.default_rng(0)
    for bitrate in bitrates:
        framebits = bitrate * 24
        syms = rng.integers(
            0, 256, (batch, C.RATE * (framebits + C.TAIL_BITS)),
            dtype=np.int64).astype(np.int32)
        for _ in range(1 + max(1, loops // 10)):          # warm up
            api.deconvolve_batch(framebits, syms)
        t0 = time.perf_counter()
        for _ in range(loops):
            ret, _ = api.deconvolve_batch(framebits, syms)
        results[bitrate] = (time.perf_counter() - t0) / loops
        if ret != 0:
            raise RuntimeError(f"deconvolve_batch returned {ret}")
    return results


def device_speed_test(variant: int, loops: int = 30,
                      batch: int = DEVICE_BATCH,
                      framebits: int = GATE_FRAMEBITS) -> float:
    """Steady-state decode rate with the symbols resident on the card —
    what the tuner decides on there: the API-path times include the
    host-to-device copy, which is most of a call and the same for every
    variant. Returns symbols/s. Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_speed_test needs a CUDA device")
    select_variant(variant)
    name = dispatch.VARIANTS[variant]
    nsteps = framebits + C.TAIL_BITS
    gen = torch.Generator(device="cuda").manual_seed(0)
    syms = torch.randint(0, 256, (batch, C.RATE * nsteps), generator=gen,
                         dtype=torch.int32, device=dispatch.state().device)
    for _ in range(max(3, loops // 4)):                   # warm up
        api._decode_tensor(syms, framebits, name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(loops):
        api._decode_tensor(syms, framebits, name)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / loops
    return batch * C.RATE * nsteps / dt


def fault_injection_test() -> bool:
    """The reference's three deliberate crashes, latch and re-arm checks
    (viterbi-benchmark.cpp:444-481). (a)+(b): a null symbol buffer
    returns 1 and latches; a valid call still returns 1 until
    ``initialize()`` re-arms. (c): a null superframe buffer returns -1
    and latches too."""
    ok = api.deconvolve(0, None, 0, None) == 1
    ok &= dispatch.state().safe_mode
    syms = golden.hard_to_soft(golden.encode(np.zeros(48, dtype=np.uint8)))
    ok &= api.deconvolve(48, syms) == 1          # still latched
    api.initialize()                              # re-arm
    ok &= api.deconvolve(48, syms) == 0
    ok &= api.rs_check_superframe(None, 0, 10, None) == -1
    ok &= dispatch.state().safe_mode
    api.initialize()
    return bool(ok)


def environment_report() -> str:
    st = dispatch.state()
    if torch.cuda.is_available():
        device = (f"{torch.cuda.get_device_name(0)} "
                  f"x{torch.cuda.device_count()}")
    else:
        device = "cpu (no CUDA device)"
    return "\n".join([
        f"device: {device}",
        f"torch: {torch.__version__} (CUDA {torch.version.cuda})",
        f"caps: 0x{st.caps:x}",
        f"variants supported: "
        f"{[dispatch.VARIANTS[i] for i in _supported_variants()]}",
        f"config: {st.config.path}",
    ])


def _tune(report: dict, variants: list[int], device_rates: dict) -> int:
    """The tuner on device-resident rates: the fastest variant whose
    (bit errors, bad frames) pair is the consensus of all variants.

    A fast variant that disagrees with the others, or failed its device
    timing, must never be written to the config. The anchor is the
    consensus pair, not variant 0's: if the baseline itself were wrong,
    anchoring on it would exclude every correct variant. Ties between
    pairs break toward fewer bit errors (a wrong decode adds errors)."""
    def pair_of(v):
        rec = report["variants"][dispatch.VARIANTS[v]]
        return rec["bit_errors"], rec["bad_frames"]

    counts = Counter(pair_of(v) for v in variants)
    consensus = min(counts, key=lambda p: (-counts[p], p[0]))
    pool = [v for v in variants
            if device_rates[dispatch.VARIANTS[v]] > 0
            and pair_of(v) == consensus] or [variants[0]]
    return max(pool, key=lambda v: device_rates[dispatch.VARIANTS[v]])


def main(argv=None) -> dict:
    """Run the harness; returns the report (also written with /json)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    frames, loops, test_exc, json_path = 500, 100, True, None
    i = 0

    def val(j):
        if j >= len(argv):
            sys.exit(f"missing value after {argv[j - 1]}")
        return argv[j]

    while i < len(argv):
        a = argv[i].lstrip("/-")
        if a == "f":
            frames = max(100, min(25000, int(val(i + 1)))); i += 2
        elif a == "t":
            loops = max(10, min(500000, int(val(i + 1)))); i += 2
        elif a == "not":
            test_exc = False; i += 1
        elif a == "json":
            json_path = val(i + 1); i += 2
        else:
            i += 1

    api.initialize()
    env = environment_report()
    print(env)
    variants = _supported_variants()
    on_card = _on_card()
    report = {"env": env.split("\n"), "frames": frames, "loops": loops,
              "batch": SPEED_BATCH, "variants": {}}
    baseline_times = None
    best, best_ratio = variants[0], 1.0  # must beat the baseline to win
    device_rates = {}
    ref_pair = None
    parity_ok = device_ok = True
    for v in variants:
        name = dispatch.VARIANTS[v]
        print(f"\nTesting variant {v} ({name}) with {frames} frames...")
        t0 = time.perf_counter()
        ber, fer, errs, bad = ber_fer_test(v, frames, GATE_FRAMEBITS)
        gate_s = time.perf_counter() - t0
        print(f"BER {errs}/{frames * GATE_FRAMEBITS} ({ber:10.3g}) "
              f"FER {bad}/{frames} ({fer:10.3g})  [{gate_s:.1f} s]")
        if ref_pair is None:
            ref_pair = (errs, bad)
        elif (errs, bad) != ref_pair:
            parity_ok = False
            print("*** PARITY FAILURE: variants disagree on identical "
                  "noise ***")
        times = speed_test(v, loops, SPEED_BATCH, SPEED_BITRATES)
        vrec = {"ber": ber, "fer": fer, "bit_errors": errs,
                "bad_frames": bad, "gate_seconds": gate_s,
                "seconds_per_loop": {}}
        for bitrate, t in times.items():
            line = (f"Bitrate: {bitrate:5d}  Framebits: {bitrate * 24:5d}  "
                    f"Time: {t * loops:8.4f} sec")
            vrec["seconds_per_loop"][str(bitrate)] = t
            if baseline_times is not None:
                ratio = baseline_times[bitrate] / t
                line += f"  {ratio:6.3f} x vs {dispatch.VARIANTS[variants[0]]}"
                if ratio > best_ratio:
                    best_ratio, best = ratio, v
            print(line)
        # time proportional to framebits (viterbi-benchmark.cpp:16-24):
        # per-framebit cost of the largest vs the smallest timed frame
        brs = sorted(times)
        t_lo, t_hi = times[brs[0]] / brs[0], times[brs[-1]] / brs[-1]
        vrec["time_per_framebit_ratio_maxmin"] = round(t_hi / t_lo, 3)
        if on_card:
            # the tuner's input on the card. A variant that fails here
            # loses the tune (rate 0) and the report's ok, but the other
            # variants are still measured.
            try:
                rate = device_speed_test(v, max(10, min(loops, 50)),
                                         DEVICE_BATCH, GATE_FRAMEBITS)
            except Exception as e:
                rate = 0.0
                vrec["device_error"] = repr(e)[:200]
                device_ok = False
                print(f"*** DEVICE FAILURE: {vrec['device_error']} ***")
            device_rates[name] = rate
            vrec["device_gsym_s"] = rate / 1e9
            print(f"device-resident: {rate / 1e9:6.2f} Gsym/s "
                  f"(B={DEVICE_BATCH}, framebits {GATE_FRAMEBITS})")
        report["variants"][name] = vrec
        if baseline_times is None:
            baseline_times = times

    if on_card and device_rates and max(device_rates.values()) > 0:
        best = _tune(report, variants, device_rates)
        rates = [device_rates[dispatch.VARIANTS[v]] for v in variants
                 if device_rates[dispatch.VARIANTS[v]] > 0]
        best_ratio = max(rates) / min(rates)
        report["tuner_basis"] = "device_resident"
    else:
        report["tuner_basis"] = "api_path"

    print(f"\nUpdating config to variant {best} "
          f"({dispatch.VARIANTS[best]}).")
    config_mod.write_variant(best)
    api.initialize()
    report["parity_ok"] = parity_ok
    report["chosen_variant"] = dispatch.VARIANTS[best]
    report["speedup_vs_slowest"] = best_ratio

    print("\nEb/N0 sweep (absolute golden anchor at the tuned variant)...")
    sweep = ebno_sweep(frames=SWEEP_FRAMES, framebits=GATE_FRAMEBITS)
    report["ebno_sweep"] = sweep
    print("ebno sweep:", "PASS" if sweep["ok"] else "FAIL",
          {p: v["bit_errors"] for p, v in sweep["points"].items()})
    report["device_ok"] = device_ok
    ok = parity_ok and device_ok and sweep["ok"]

    if test_exc:
        print("\nChecking the fault-recovery subsystem...")
        fi = fault_injection_test()
        report["fault_injection"] = "PASS" if fi else "FAIL"
        print("fault injection:", report["fault_injection"])
        ok &= fi
    report["ok"] = ok

    if json_path:
        with open(json_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {json_path}")
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
