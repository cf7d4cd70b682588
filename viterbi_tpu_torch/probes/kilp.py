"""Issue rate against dependency chains: N independent streams of
``v = min(v + c, v)`` per thread, in int32, float32 or alternating
(kernel H). Counterpart of ``scripts/kilp.py``.

With one stream every operation waits for the one before it; with more,
the scheduler has independent work, until the issue rate is the limit.
The stream count at which lane-operations per second stop growing says
how much instruction-level parallelism one thread of the ACS kernels can
use; the mixed mode says whether integer and float work issue side by
side. The table is printed twice: on the TPU probe's [64, 2048] lanes
(about eight warps per scheduler, which hide latency by themselves) and
on ``LOW_SHAPE``, two warps per scheduler, where only a thread's own
independent streams can.

Usage: python -m viterbi_tpu_torch.probes.kilp [--rounds N] [--iters N]
"""

from __future__ import annotations

import argparse

import torch

from ..ops import _build
from . import _common

STREAMS = (1, 2, 4, 8)
MODES = ("int", "float", "mixed")        # C codes 0..2
SHAPE = (64, 2048)
#: two warps per scheduler (132 SMs x 256 threads): near the occupancy of
#: the ACS kernels, whose 254 registers a thread leave one
LOW_SHAPE = (16, 2112)
LOW_ROUNDS_FACTOR = 8   # more rounds there, so a launch's cost stays small
ROUNDS = 2000
OPS_PER_STREAM = 2                        # min(v + c, v) twice a round
C_ADD = 3


def _is_float(mode: str, k: int) -> bool:
    return mode == "float" or (mode == "mixed" and k % 2 == 1)


def _check(x: torch.Tensor, nstreams: int, mode: str) -> None:
    if nstreams not in STREAMS:
        raise ValueError(f"nstreams must be one of {STREAMS}, got {nstreams}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dtype != torch.int32:
        raise ValueError(f"x must be int32, got {x.dtype}")


def streams_plain(x: torch.Tensor, nstreams: int, mode: str, rounds: int,
                  c: int = C_ADD) -> torch.Tensor:
    """Plain version of kernel H: stream k starts at x + k (as float32
    where the mode says so), runs its rounds, and the streams' int32
    values are summed."""
    _check(x, nstreams, mode)
    vs = [(x + k).to(torch.float32) if _is_float(mode, k) else x + k
          for k in range(nstreams)]
    for _ in range(rounds):
        for _ in range(OPS_PER_STREAM):
            vs = [torch.minimum(v + c, v) for v in vs]
    acc = torch.zeros_like(x)
    for v in vs:
        acc = acc + v.to(torch.int32)
    return acc


def streams(x: torch.Tensor, nstreams: int, mode: str, rounds: int,
            c: int = C_ADD) -> torch.Tensor:
    """``nstreams`` independent streams per lane for ``rounds`` rounds.

    ``x``: int32 lanes; ``nstreams`` in ``STREAMS``; ``mode`` in
    ``MODES``. Returns int32: the sum of the streams' final values.

    Kernel H on a CUDA tensor, the plain version on a CPU tensor;
    ``streams.launches`` counts the kernel's launches.
    """
    _check(x, nstreams, mode)
    if x.device.type == "cpu":
        return streams_plain(x, nstreams, mode, rounds, c)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        lib = _build.load(library=_build.PROBES)
        err = lib.kilp_streams_launch(
            nstreams, MODES.index(mode), x.data_ptr(), out.data_ptr(),
            x.numel(), rounds, c, x.device.index or 0,
            _build.stream_arg(x.device))
        _build.check(lib, err, "kilp_streams")
        streams.launches += 1
    return out


streams.launches = 0


def run(rounds: int = ROUNDS, iters: int = 10, shape=SHAPE) -> list[dict]:
    """The probe's table on ``shape`` lanes: per mode and stream count,
    ms, ms at half the rounds (the loop must be there: the time grows
    with the rounds) and lane-operations per second (add and min count
    one each)."""
    dev = _common.require_card()
    x = torch.ones(shape, dtype=torch.int32, device=dev)
    rows = []
    for mode in MODES:
        for n in STREAMS:
            ms = _common.device_ms(lambda: streams(x, n, mode, rounds), iters)
            half_ms = _common.device_ms(
                lambda: streams(x, n, mode, rounds // 2), iters)
            total_ops = rounds * n * OPS_PER_STREAM * 2
            rows.append({"mode": mode, "streams": n, "ms": ms,
                         "half_rounds_ms": half_ms,
                         "lane_ops_per_s": total_ops * x.numel()
                         / (ms * 1e-3)})
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    _common.require_card()
    card = _common.card_line()
    rows = []
    for shape, rounds in ((SHAPE, args.rounds),
                          (LOW_SHAPE, args.rounds * LOW_ROUNDS_FACTOR)):
        table = run(rounds, args.iters, shape)
        print(f"kilp on {card}: {rounds} rounds over {shape} lanes")
        for r in table:
            print(f"  {r['mode']:6s} streams={r['streams']}  "
                  f"{r['ms']:8.3f} ms  (half the rounds "
                  f"{r['half_rounds_ms']:8.3f} ms)  "
                  f"{r['lane_ops_per_s'] / 1e12:6.2f} T lane-ops/s")
        rows += [dict(r, shape=shape) for r in table]
    return rows


if __name__ == "__main__":
    main()
