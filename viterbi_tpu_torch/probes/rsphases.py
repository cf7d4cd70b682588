"""Where kernel I's time goes, step by step, on the card.

``csrc/probes/rs_phases.cu`` is kernel I's superframes entry with the
card's clock taken by each block after each of its steps: the tables and
the staging, the syndromes (the tensor cores' product), the dirty
codewords (Berlekamp-Massey, Chien, Forney, a warp each), the sums and the
audio. For each batch this prints each step's mean and largest time over
the blocks, the kernel's span (first start to last end), the median
block's end, and the dirty codewords a block; the output is held against
``ops.rs.rs_check_superframes_plain`` bit for bit.

Usage: python -m viterbi_tpu_torch.probes.rsphases
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from .. import golden
from ..ops import _build
from ..ops import rs as rs_ops
from . import _common
from .rsform import corrupt_mix

STEPS = ("tables and staging", "syndromes", "dirty codewords", "sums",
         "audio")
#: (name, superframes, rs_dims, share of dirty codewords, most errors in
#: one, codewords with nine errors): the chain's batch at 128 kbit/s and
#: its share of dirty codewords (1947 of 32768 in chip_smoke.py phase 8),
#: the same batch clean, and the export's single superframes
CASES = (("chain, 6 % dirty", 2048, 16, 0.06, 2, 8),
         ("chain, clean", 2048, 16, 0.0, 0, 0),
         ("export, 6 % dirty", 1, 16, 0.06, 2, 0),
         ("export, 6 % dirty", 1, 48, 0.06, 2, 0))


def superframes(rng, G: int, rs_dims: int, frac: float, max_errs: int,
                bad: int) -> np.ndarray:
    """G byte-interleaved superframes with a mix's errors planted."""
    clean = golden.rs_encode_many(rng.integers(
        0, 256, (G * rs_dims, C.RS_KK), dtype=np.uint8))
    cws = corrupt_mix(rng, clean, frac, max(max_errs, 1), bad)[0] \
        if frac or bad else clean
    return np.ascontiguousarray(cws.reshape(G, rs_dims, C.RS_N)
                                .transpose(0, 2, 1).reshape(G, -1))


def phases(sf: torch.Tensor, rs_dims: int) -> dict:
    """One launch of the probe on ``sf`` (uint8 [G, rs_dims*120] on the
    card): each block's step times in us, its end and its dirty
    codewords, and the kernel's span; raises unless the output equals
    the plain version's."""
    G, dev = sf.shape[0], sf.device
    tables, frags = rs_ops._kernel_consts(dev)
    errors = torch.empty(G, dtype=torch.int32, device=dev)
    n_ok = torch.empty(G, dtype=torch.int32, device=dev)
    out = torch.empty((G, rs_dims * C.RS_KK), dtype=torch.uint8, device=dev)
    sms = rs_ops._sms(dev.index)
    stamps = torch.zeros(sms * 8 * 8, dtype=torch.int64, device=dev)
    shape = np.zeros(2, np.int32)
    _build.RS_PHASES.launch(
        dev, sf.data_ptr(), sf.stride(0) if G > 1 else sf.shape[1], G,
        rs_dims, tables.data_ptr(), frags.data_ptr(), errors.data_ptr(),
        out.data_ptr(), n_ok.data_ptr(), stamps.data_ptr(),
        shape.ctypes.data, sms)
    torch.cuda.synchronize(dev)
    want = rs_ops.rs_check_superframes_plain(sf, rs_dims,
                                             zero_after_fail=False)
    for got, w, part in zip((errors, out, n_ok), want,
                            ("errors", "audio", "n_ok")):
        if not torch.equal(got, w):
            raise AssertionError(f"rs_phases differs from the plain "
                                 f"version ({part})")
    grid = int(shape[0])
    st = stamps[:grid * 8].view(grid, 8).cpu().numpy()
    t0 = st[:, 0].min()
    steps_us = np.diff(st[:, :6], axis=1) / 1e3
    return {"blocks": grid, "per_block": int(shape[1]),
            "span_us": float((st[:, 5].max() - t0) / 1e3),
            "end_p50_us": float(np.median((st[:, 5] - t0) / 1e3)),
            "mean_us": steps_us.mean(axis=0).tolist(),
            "max_us": steps_us.max(axis=0).tolist(),
            "dirty_mean": float(st[:, 7].mean()),
            "dirty_max": int(st[:, 7].max())}


def run(repeats: int = 3) -> list[dict]:
    """Every case, the last of ``repeats`` launches (the first builds and
    warms up)."""
    dev = _common.require_card()
    rng = np.random.default_rng(7)
    rows = []
    for name, G, rs_dims, frac, max_errs, bad in CASES:
        sf = torch.from_numpy(superframes(rng, G, rs_dims, frac, max_errs,
                                          bad)).to(dev)
        for _ in range(repeats):
            got = phases(sf, rs_dims)
        rows.append({"case": name, "superframes": G, "rs_dims": rs_dims,
                     **got})
    return rows


def main(argv=None) -> list[dict]:
    _common.require_card()
    rows = run()
    print(f"kernel I's steps on {_common.card_line()} (us; mean and "
          f"largest over the blocks; each output equal to the plain "
          f"version)")
    for r in rows:
        print(f"  {r['case']:18s} {r['superframes']:5d} x {r['rs_dims']:2d}"
              f": {r['blocks']} blocks of {r['per_block']}, span "
              f"{r['span_us']:.2f}, median block end {r['end_p50_us']:.2f}"
              f", dirty codewords a block {r['dirty_mean']:.2f} (at most "
              f"{r['dirty_max']})")
        for name, mean, top in zip(STEPS, r["mean_us"], r["max_us"]):
            print(f"      {name:19s} {mean:7.2f} {top:7.2f}")
    return rows


if __name__ == "__main__":
    main()
