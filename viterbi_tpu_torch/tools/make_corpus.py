"""Regenerate the capture-replay corpus through the port, the twin of
``scripts/make_corpus.py``.

It decodes noisy 3 dB frames (2 at each of 8, 32, 64, 128, 384 kbit/s)
and three DAB+ superframes (clean, corrected, uncorrectable) through the
public API with the call logger's symbol capture on
(``runtime.calllog.configure(True, symbols=True, ...)``), then promotes
the captured streams into the output directory with their expectations
(the golden decode, the golden RS outcome). The run is deterministic: the
``.npy`` files come out byte for byte as in ``tests/data/corpus``; the
``.npz`` expectations equal it by keys and arrays (``np.savez`` stamps
its zip entries with the time). The committed corpus is never the output.

Usage: python -m viterbi_tpu_torch.tools.make_corpus OUTDIR
       [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

from .. import constants as C
from .. import golden
from ..harness import channel
from ..runtime.placement import strict_device
from . import _record

BITRATES = (8, 32, 64, 128, 384)     # kbit/s; framebits = 24 * kbps
FRAMES_PER_BITRATE = 2
RS_DIMS = 16
COMMITTED = _record.ROOT / "tests" / "data" / "corpus"


def run(outdir, device=None) -> int:
    """Write the 13 captures and their expectations into ``outdir``;
    returns how many. The API must decode on ``device``'s kind (the card,
    unless ``"cpu"``): a caller on the CPU has called
    ``initialize(device="cpu")``, as ``main`` does for ``--device cpu``."""
    import viterbi_tpu_torch as api
    from ..runtime import calllog, dispatch
    dev = strict_device(device)
    out = Path(outdir)
    if out.resolve() == COMMITTED.resolve():
        raise ValueError(f"{out} is the committed corpus; write elsewhere")
    api.initialize()
    api_dev = dispatch.ready().device
    if api_dev.type != dev.type:
        raise RuntimeError(f"the API decodes on {api_dev}, "
                           f"not on {dev}")
    out.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="vit_corpus_")
    try:
        calllog.configure(True, symbols=True, path=os.path.join(tmp, "cap"))
        try:
            deco, rs_cases = _capture(api)
        finally:
            calllog.configure(False)
        captured = sorted(glob.glob(os.path.join(tmp, "cap_sym", "*.npy")))
        return _promote(captured, deco, rs_cases, out)
    finally:
        shutil.rmtree(tmp)


def _capture(api):
    """Decode through the API while the logger captures: returns the
    (name, symbols) of each frame and each superframe case's (name,
    interleaved bytes, error count)."""
    deco = []
    for kbps in BITRATES:
        fb = 24 * kbps
        _, syms = channel.make_frames(FRAMES_PER_BITRATE, fb,
                                      seed=1000 + kbps)
        for i in range(FRAMES_PER_BITRATE):
            if api.deconvolve(fb, syms[i].astype(np.int32)) != 0:
                raise RuntimeError(f"deconvolve at {kbps} kbit/s failed")
            deco.append((f"{kbps:03d}kbps{i}", syms[i]))
    rng = np.random.default_rng(77)
    rs_cases = []
    for case, spec in (("clean", None), ("mixed", "correctable"),
                       ("uncorr", "uncorrectable")):
        msgs = rng.integers(0, 256, (RS_DIMS, C.RS_KK), dtype=np.uint8)
        cws = np.stack([golden.rs_encode_codeword(m)
                        for m in msgs]).astype(np.int64)
        if spec == "correctable":
            for j in range(RS_DIMS):
                e = int(rng.integers(0, 6))
                if e:
                    pos = rng.choice(C.RS_N, e, replace=False)
                    cws[j, pos] ^= rng.integers(1, 256, e)
        elif spec == "uncorrectable":
            pos = rng.choice(C.RS_N, 9, replace=False)
            cws[3, pos] ^= rng.integers(1, 256, 9)  # codeword 3: > t errors
        inter = cws.T.reshape(-1).astype(np.uint8)
        outbuf = np.zeros(RS_DIMS * C.RS_KK, dtype=np.uint8)
        errors = api.rs_check_superframe(inter.astype(np.int32), 0, RS_DIMS,
                                         outbuf)
        rs_cases.append((case, inter, int(errors)))
    return deco, rs_cases


def _promote(captured, deco, rs_cases, out: Path) -> int:
    """The captured streams and their expectations into ``out``."""
    deco_caps = [p for p in captured if p.endswith("_deco.npy")]
    rs_caps = [p for p in captured if p.endswith("_rscs.npy")]
    if len(deco_caps) != len(deco) or len(rs_caps) != len(rs_cases):
        raise RuntimeError(f"captured {len(deco_caps)} + {len(rs_caps)} "
                           f"streams, decoded {len(deco)} + {len(rs_cases)}")
    for cap, (name, syms) in zip(deco_caps, deco):
        arr = np.load(cap)
        if not np.array_equal(arr.astype(np.uint32), syms):
            raise RuntimeError(f"capture {name} != the symbols decoded")
        np.save(out / f"{name}_deco.npy", arr.astype(np.uint8))
        fb = arr.size // C.RATE - C.TAIL_BITS
        np.save(out / f"{name}_deco.expect.npy", golden.deconvolve(fb, arr))
    for cap, (case, inter, errors) in zip(rs_caps, rs_cases):
        arr = np.load(cap)
        if not np.array_equal(arr.astype(np.uint8), inter):
            raise RuntimeError(f"capture {case} != the superframe checked")
        np.save(out / f"sf{case}_rscs.npy", arr.astype(np.uint8))
        g_err, g_out = golden.rs_check_superframe(inter, RS_DIMS)
        if g_err != errors:
            raise RuntimeError(f"{case}: the API said {errors}, golden "
                               f"{g_err}")
        np.savez(out / f"sf{case}_rscs.expect.npz", errors=np.int64(errors),
                 rs_dims=np.int64(RS_DIMS), out=g_out.astype(np.uint8))
    return len(deco_caps) + len(rs_caps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--device", default=None,
                    help="cpu to decode on the CPU (default: the card)")
    args = ap.parse_args(argv)
    from .. import api
    api.initialize(device=args.device)   # this process's API device
    n = run(args.outdir, args.device)
    total = sum(p.stat().st_size for p in Path(args.outdir).iterdir())
    print(f"corpus: {n} captures -> {args.outdir} ({total / 1024:.0f} KiB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
