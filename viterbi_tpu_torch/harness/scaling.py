"""Several-rank scaling sweep: the port of ``viterbi_tpu.harness.scaling``
(BASELINE.json config 5).

Measures the decoded throughput of the data-parallel sharded decoder
(``parallel.batch.decode_sharded``) at 1, 2, 4, ... ranks and reports the
scaling efficiency against the one-rank rate. The sweep starts its ranks
itself (``parallel.distributed.run_ranks``: fresh processes over a
``FileStore``, each size under a wall-clock limit), all on one device,
over gloo. On one card the ranks share it, as the JAX sweep's virtual
CPU devices shared the host's cores, so the prediction is a roughly flat
total rate (``predicted_efficiency_envelope``).

Usage: python -m viterbi_tpu_torch.harness.scaling [frames_per_device]
       [framebits] [--device DEV] [--json PATH]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def predicted_efficiency_envelope(n: int) -> tuple[float, float]:
    """Falsifiable per-size efficiency bounds for ranks that share one
    device. The one-rank run already fills it, so the honest prediction
    is a roughly FLAT total rate as ranks grow: efficiency(n) = rate_n /
    (n * rate_1) >= 0.85/n (a sharding that SERIALIZES and adds per-rank
    overhead drops the total below flat and falls out of the envelope),
    and <= 1.2 (superlinear = measurement error). Per-device linearity
    needs a device a rank."""
    return 0.85 / n, 1.2


def _sweep_rank(rank: int, world_size: int, store, frames_per_device: int,
                framebits: int, loops: int, repeats: int,
                device: str) -> float:
    """One rank of one size: the best of ``repeats`` timed passes of
    ``loops`` calls, seconds a call (every call ends in the gather, which
    waits for every rank)."""
    import viterbi_tpu_torch
    from .. import constants as C
    from ..parallel import batch as batch_mod
    from ..parallel import mesh as mesh_mod

    viterbi_tpu_torch.initialize(device=device)
    mesh = mesh_mod.make_mesh(world_size, 1, rank=rank,
                              world_size=world_size, store=store,
                              device=device)
    rng = np.random.default_rng(world_size)     # the same batch everywhere
    B = frames_per_device * world_size
    syms = rng.integers(0, 256, (B, C.RATE * (framebits + C.TAIL_BITS)),
                        dtype=np.uint8)
    batch_mod.decode_sharded(syms, framebits, mesh).cpu()   # warm
    dt = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(loops):
            out = batch_mod.decode_sharded(syms, framebits, mesh)
        out.cpu()
        dt = min(dt, (time.perf_counter() - t0) / loops)
    return dt


def sweep(frames_per_device: int = 32, framebits: int = 3072,
          loops: int = 5, repeats: int = 3, max_ranks: int = 4,
          device=None, timeout: float = 600.0) -> dict:
    """Decoded Mbit/s and efficiency at 1, 2, 4, ... up to ``max_ranks``
    ranks, all on ``device`` (default ``cuda:0``; a host without a card
    passes ``"cpu"``). Each size's ranks must finish within ``timeout``
    seconds. A call's time is its slowest rank's."""
    from ..ops import _build
    from ..parallel import distributed

    device = distributed.local_device(device)
    if device.type == "cuda":
        _build.build()       # once, before the ranks load it
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= max_ranks]
    results = {}
    base_rate = None
    for n in sizes:
        dt = max(distributed.run_ranks(
            _sweep_rank, n, (frames_per_device, framebits, loops, repeats,
                             str(device)), timeout=timeout))
        rate = frames_per_device * n * framebits / dt  # decoded bits/s
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n)
        lo, hi = predicted_efficiency_envelope(n)
        results[n] = {"mbit_s": rate / 1e6, "efficiency": eff,
                      "predicted_envelope": [round(lo, 3), hi]}
    return results


def _option(argv: list, name: str):
    """Pop ``name VALUE`` from ``argv``; the value, or None."""
    if name not in argv:
        return None
    i = argv.index(name)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv=None):
    import torch

    argv = list(sys.argv[1:] if argv is None else argv)
    json_path = _option(argv, "--json")
    device = _option(argv, "--device")
    fpd = int(argv[0]) if len(argv) > 0 else 32
    fb = int(argv[1]) if len(argv) > 1 else 3072
    results = sweep(fpd, fb, device=device)
    for n, r in results.items():
        print(f"ranks={n:3d}  decoded {r['mbit_s']:10.2f} Mbit/s  "
              f"efficiency {r['efficiency']:6.1%}  envelope "
              f"{r['predicted_envelope']}")
    if json_path:
        from ..parallel import distributed
        dev = distributed.local_device(device)
        on_card = dev.type == "cuda"
        where = (torch.cuda.get_device_name(dev) if on_card
                 else f"the host's {os.cpu_count()} cores")
        payload = {
            "platform": "gpu" if on_card else "cpu",
            "frames_per_device": fpd,
            "framebits": fb,
            "sweep": {str(n): r for n, r in results.items()},
            "note": (f"every rank on {dev} ({where}), over gloo: the ranks "
                     f"share it, so the total rate is bound by that one "
                     f"device, not by the sharding"),
        }
        with open(json_path, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {json_path}")


if __name__ == "__main__":
    main()
