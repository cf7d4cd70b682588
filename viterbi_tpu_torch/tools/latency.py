"""Per-call decode latency at small batches, the twin of
``scripts/latency_bench.py`` (``LATENCY_TPU.json``). Writes
``LATENCY_GPU.json``.

A live receiver calls the decoder many times a second with a few frames
and has a 24 ms logical frame (120 ms a DAB+ superframe) to spend. This
records p50 and p99 of one call over ``iters`` calls at B in {1, 16, 256}
x {32, 128, 384} kbit/s, every call ended by reading its bytes back to
the host, two ways: through ``deconvolve_batch`` (host symbols in, host
bytes out: what a QIRX call pays) and with the symbols resident on the
device (``acs_cuda.decode``, kernels A and B). Then the DAB+ superframe
chain (``models.dab.decode_audio_superframes``, 96 kbit/s) at B = 1 and
16 both ways, the dispatch floor (a one-element ``torch.add`` read back)
and the headroom: the budget over p99.

Usage: python -m viterbi_tpu_torch.tools.latency [--iters N]
       [--device cpu] [--out PATH]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import constants as C
from ..runtime.placement import strict_device
from . import _record

BITRATES = (32, 128, 384)
BATCHES = (1, 16, 256)
SF_BATCHES = (1, 16)
SF_KBPS = 96
FRAME_MS = 24.0
SUPERFRAME_MS = 120.0


def _row(lat, floor_p50, budget_ms, **key) -> dict:
    p = _record.percentiles(lat)
    return dict(key, **p, net_of_floor_p50_ms=p["p50_ms"] - floor_p50,
                budget_ms=budget_ms, headroom_p99=budget_ms / p["p99_ms"])


def run(iters: int = 200, device=None, bitrates=BITRATES, batches=BATCHES,
        sf_batches=SF_BATCHES, warmup: int = 10) -> dict:
    import viterbi_tpu_torch
    from ..models import dab
    from ..ops import acs_cuda
    from ..runtime import dispatch
    dev = strict_device(device)
    viterbi_tpu_torch.initialize()
    st = dispatch.ready()
    if st.device.type != dev.type:
        raise RuntimeError(f"the API decodes on {st.device}, not on {dev}")
    rung = dispatch.VARIANTS[st.variant]
    rng = np.random.default_rng(0)
    one = torch.zeros(1, device=dev)
    floor = _record.per_call_ms(lambda: torch.add(one, 1), iters, warmup)
    floor_p = _record.percentiles(floor)
    print(f"dispatch floor p50 {floor_p['p50_ms']:.4f} ms", flush=True)
    _record.zero_launches()
    rows = []
    for kbps in bitrates:
        fb = 24 * kbps
        for B in batches:
            syms = rng.integers(0, 256, (B, C.RATE * (fb + C.TAIL_BITS)),
                                dtype=np.int32)
            resident = torch.from_numpy(syms).to(dev)
            calls = {
                "deconvolve_batch": lambda: viterbi_tpu_torch.deconvolve_batch(
                    fb, syms)[1],
                "resident": lambda: acs_cuda.decode(resident, fb)}
            for how, fn in calls.items():
                rows.append(_row(_record.per_call_ms(fn, iters, warmup),
                                 floor_p["p50_ms"], FRAME_MS * B, kbps=kbps,
                                 framebits=fb, batch=B, call=how))
                print(rows[-1], flush=True)
    sf_rows = []
    fb = 24 * SF_KBPS
    for B in sf_batches:
        sf = rng.integers(0, 256, (B, 5, C.RATE * (fb + C.TAIL_BITS)),
                          dtype=np.int32)
        resident = torch.from_numpy(sf).to(dev)
        calls = {"host": lambda: dab.decode_audio_superframes(
                     sf, SF_KBPS, device=dev)[0],
                 "resident": lambda: dab.decode_audio_superframes(
                     resident, SF_KBPS)[0]}
        for how, fn in calls.items():
            sf_rows.append(_row(_record.per_call_ms(fn, iters, warmup),
                                floor_p["p50_ms"], SUPERFRAME_MS * B,
                                kbps=SF_KBPS, batch=B, call=how))
            print(sf_rows[-1], flush=True)
    _record.sync(dev)
    counts = _record.launches()
    lost = (_record.missing(counts, ("acs_regs", "tb_walk"))
            if dev.type == "cuda" else [])
    return dict(
        device=_record.stamp(dev), iters=iters, warmup=warmup, rung=rung,
        dispatch_floor_ms=floor_p, deconvolve=rows, superframe_chain=sf_rows,
        launches=counts, kernels_not_launched=lost, ok=not lost,
        note=("wall ms of one call, each ended by reading its output back "
              "to the host, after warmup calls; deconvolve_batch: host "
              "int32 symbols in, host bytes out, on the dispatcher's rung; "
              "resident: acs_cuda.decode (kernels A and B) on symbols "
              "already on the device; headroom_p99 = budget / p99, the "
              "budget 24 ms a frame and 120 ms a superframe, times B"))


def main(argv=None) -> int:
    ap = _record.parser(__doc__)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    from .. import api
    api.initialize(device=args.device)   # this process's API device
    return _record.finish(run(args.iters, args.device), args.out, "LATENCY")


if __name__ == "__main__":
    sys.exit(main())
