"""Ablation of kernel A: times the fused register-exchange ACS with
parts of its step left out, to locate what costs most on the card.

Counterpart of ``scripts/kablate.py``. Kernel E (``csrc/probes/kablate.cu``)
is not a copy of kernel A but the same device code (``csrc/acs_regs.cuh``)
instantiated with compile-time switches, so ``full`` is kernel A bit for
bit and the variants cannot drift from it. Every variant has a defined
result: ``acs_cuda.forward_regs_plain`` with the same parts left out.

The TPU probe's switches and what stands for each here:

* ``noreg``, ``norenorm``, ``nosat``, ``nobm``: the same parts of the
  step (register exchange, renormalization, saturation, branch metrics).
* ``nomerge``, ``noreset``: the TPU's row interleave and 8x8 transposes
  that put each new state back in its row. With one lane a frame there
  is neither: the butterfly permutation is register renaming inside the
  unrolled steps and costs no instruction. With four lanes a frame the
  exchange every three steps stands for them, and a step without it has
  no defined result. No switch; the two forms' ``full`` rows tell what
  the lanes cost and bring.
* ``staticbit``: the TPU's choice between shifting every register each
  step and placing the bit at a static position. Here the shift comes
  once a six-step window and goes with ``noreg``. No switch of its own.

Every variant exists in kernel A's one-lane and four-lane forms
(``lanes`` 1 or 4; not in its warp-wide form); the table is printed for
the one of the two kernel A takes at the probe's batch and, with
``--lanes``, for the other.

Usage: python -m viterbi_tpu_torch.probes.kablate [--framebits N]
       [--batch N] [--iters N] [--lanes 1|4]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import constants as C
from ..ops import _build, acs_cuda
from . import _common

ABLATE_THREADS = acs_cuda.ACS_THREADS
_MASK = {"noreg": 1, "norenorm": 2, "nosat": 4, "nobm": 8}
#: the instantiated variants, in the order of the probe's table
VARIANTS = (
    ("full", ()),
    ("no reg-exchange", ("noreg",)),
    ("no renorm", ("norenorm",)),
    ("no sat", ("nosat",)),
    ("no branch metrics", ("nobm",)),
    ("bare ACS", ("noreg", "norenorm", "nosat", "nobm")),
)


def forward_regs_ablated_plain(symbols: torch.Tensor, nsteps: int,
                               ablate=(), ckpt: int | None = None,
                               packed: bool | str = "bt"):
    """Plain version of kernel E: ``forward_regs_plain``'s arithmetic with
    the named parts left out."""
    return acs_cuda.forward_regs_plain(symbols, nsteps, ckpt=ckpt,
                                       packed=packed,
                                       ablate=frozenset(ablate))


def forward_regs_ablated(symbols: torch.Tensor, nsteps: int, ablate=(),
                         ckpt: int | None = None,
                         packed: bool | str = "bt",
                         lanes: int | None = None):
    """Kernel A's forward pass with the parts named in ``ablate`` left out.

    ``symbols``: one packed word per step, frame-major [B, >=nsteps]
    (``packed="bt"``) or time-major [>=nsteps, B] (``packed=True``).
    ``ablate``: one of the sets in ``VARIANTS``. Returns what
    ``forward_regs`` returns: (registers int32[ceil(nsteps/ckpt), 64, B],
    metrics int32[B, 64]); with ``noreg`` the registers hold their seeds.
    ``lanes`` 1 or ``acs_cuda.LANES``: left out, the one of those two
    forms kernel A takes at this batch.

    Kernel E on a CUDA tensor, the plain version on a CPU tensor.
    """
    if not packed:
        raise ValueError("the ablation kernel reads packed symbols")
    ablate = frozenset(ablate)
    if ablate not in {frozenset(a) for _, a in VARIANTS}:
        raise ValueError(f"no instantiation leaves out {sorted(ablate)}")
    if symbols.device.type == "cpu":
        return forward_regs_ablated_plain(symbols, nsteps, ablate, ckpt,
                                          packed)
    if symbols.device.type != "cuda":
        raise ValueError(f"unsupported device {symbols.device}")
    total, ckpt, K, _ = acs_cuda._layout(nsteps, ckpt, 0)
    B = acs_cuda._batch(symbols, nsteps, packed)
    dev = symbols.device
    sym, sb, st, _ = acs_cuda._strided(symbols, packed)
    init = acs_cuda._init_metrics(None, B, dev)
    lanes = acs_cuda._lanes(B, acs_cuda.REGS_ONE_LANE_FRAMES, lanes)
    regs = torch.empty((K, C.NUM_STATES, B), dtype=torch.int32, device=dev)
    metrics = torch.empty((B, C.NUM_STATES), dtype=torch.int32, device=dev)
    if B == 0:
        return regs, metrics
    _build.KABLATE.launch(
        dev, sym.data_ptr(), sb, st, sum(_MASK[a] for a in ablate),
        init.data_ptr(), B, total, ckpt, regs.data_ptr(), metrics.data_ptr(),
        lanes, ABLATE_THREADS)
    return regs, metrics


def run(framebits: int = 3072, batch: int = 8192, iters: int = 30,
        lanes: int | None = None) -> dict:
    """Time every variant on the card; returns {name: ms} with kernel A
    itself, in the same form, under ``"kernel A"``."""
    dev = _common.require_card()
    nsteps = framebits + C.TAIL_BITS
    rng = np.random.default_rng(0)
    words = torch.from_numpy(rng.integers(
        -2**31, 2**31, (batch, nsteps), dtype=np.int64).astype(np.int32)) \
        .to(dev)
    ck = acs_cuda.DECODE_CKPT
    times = {"kernel A": _common.device_ms(
        lambda: acs_cuda.forward_regs(words, nsteps, ckpt=ck, packed="bt",
                                      lanes=lanes), iters)}
    for name, ablate in VARIANTS:
        times[name] = _common.device_ms(
            lambda: forward_regs_ablated(words, nsteps, ablate, ck,
                                         lanes=lanes), iters)
    return times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--framebits", type=int, default=3072)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--lanes", type=int, choices=(1, acs_cuda.LANES),
                    help="the kernel's form (default: kernel A's choice "
                         "at this batch)")
    args = ap.parse_args(argv)
    _common.require_card()
    times = run(args.framebits, args.batch, args.iters, args.lanes)
    lanes = acs_cuda._lanes(args.batch, acs_cuda.REGS_ONE_LANE_FRAMES,
                            args.lanes)
    nsym = args.batch * C.RATE * (args.framebits + C.TAIL_BITS)
    print(f"kablate on {_common.card_line()}: B={args.batch} x framebits "
          f"{args.framebits}, ckpt {acs_cuda.DECODE_CKPT}, {lanes} "
          f"lane(s) a frame, {args.iters} launches each")
    full = times["full"]
    for name, ms in times.items():
        print(f"  {name:20s} {ms:8.3f} ms  {nsym / ms / 1e6:7.2f} Gsym/s  "
              f"{100 * (full - ms) / full:+6.1f} % of full saved")
    return times


if __name__ == "__main__":
    main()
