"""What the probes' ``main()`` functions share: the card, its clock and
its launch count."""

from __future__ import annotations

import subprocess

import torch


def require_card() -> torch.device:
    """The card, or an error: a probe measures nothing on a CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("this probe times CUDA kernels and needs a CUDA "
                           "device")
    return torch.device("cuda", torch.cuda.current_device())


def card_line() -> str:
    """The card's name and power limit, as every kept number carries."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back runs
    (CUDA events), after ``warmup`` untimed runs."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def count_launches(fn):
    """Device launches (kernels, copies, memsets) of one run of ``fn``,
    read from torch.profiler; None where the profiler sees no device."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = 0
    for k in prof.key_averages():
        dev_us = getattr(k, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(k, "self_cuda_time_total", 0)
        if dev_us > 0:
            n += k.count
    return n or None
