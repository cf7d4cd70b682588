"""Replay captured symbol streams — the offline half of the reference's
VIT_WRITE_SYMBOLS fixture mechanism (viterbi.h:73-80), port of
``viterbi_tpu.harness.replay``: symbol streams captured by the call
logger (runtime.calllog) are decoded again through the port's API and
checked bit-exactly against the golden oracle or their recorded
outputs, turning production traffic into regression fixtures.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .. import api
from .. import constants as C
from .. import golden


def iter_captures(capture_dir: str):
    """Yield (path, kind, symbols) for every capture in a _sym dir."""
    for path in sorted(glob.glob(os.path.join(capture_dir, "*.npy"))):
        kind = os.path.basename(path).split("_", 1)[1].removesuffix(".npy")
        yield path, kind, np.load(path)


def infer_framebits(symbols: np.ndarray) -> int:
    """Captured deconvolve streams have 4*(framebits+6) entries."""
    n = symbols.size
    assert n % C.RATE == 0
    return n // C.RATE - C.TAIL_BITS


def replay(capture_dir: str, against_golden: bool = True):
    """Re-decode every captured stream; returns (n_ok, n_total, report).

    Each deconvolve capture is decoded through the live dispatch path
    and (optionally) compared bit-exactly to the golden oracle.
    """
    results = []
    n_ok = 0
    n_total = 0
    for path, kind, syms in iter_captures(capture_dir):
        if kind != "deco":
            continue
        n_total += 1
        framebits = infer_framebits(syms)
        ret, out = api.deconvolve_batch(framebits, syms[None])
        ok = ret == 0
        if ok and against_golden:
            expect = golden.deconvolve(framebits, syms)
            ok = bool(np.array_equal(out[0], expect))
        n_ok += ok
        results.append((os.path.basename(path), framebits, ok))
    return n_ok, n_total, results


def replay_corpus(corpus_dir: str):
    """Replay a committed capture corpus against its recorded outputs.

    The corpus layout extends the capture-dir layout with expectation
    files (the reference's VIT_WRITE_SYMBOLS fixtures are exactly this:
    harvested traffic replayed against known-good decodes):

      * ``<name>_deco.npy``        uint8 soft symbols, one frame
        ``<name>_deco.expect.npy`` uint8 packed decode output
      * ``<name>_rscs.npy``        uint8 interleaved superframe bytes
        ``<name>_rscs.expect.npz`` ``errors`` (int), ``out`` (uint8
        corrected data bytes), ``rs_dims``

    Every capture is re-decoded through the live dispatch path and
    compared bit-exactly to the committed expectation. Returns
    (n_ok, n_total, [(file, kind, ok), ...]).
    """
    results = []
    n_ok = 0
    n_total = 0
    for path, kind, data in iter_captures(corpus_dir):
        if kind.endswith(".expect") or kind.startswith("deco.") \
                or kind.startswith("rscs."):
            continue
        base = path.removesuffix(".npy")
        n_total += 1
        if kind == "deco":
            expect = np.load(base + ".expect.npy")
            framebits = infer_framebits(data)
            ret, out = api.deconvolve_batch(framebits,
                                            data.astype(np.int32)[None])
            ok = ret == 0 and bool(np.array_equal(out[0], expect))
        elif kind == "rscs":
            ex = np.load(base + ".expect.npz")
            rs_dims = int(ex["rs_dims"])
            assert data.size == rs_dims * C.RS_N
            outbuf = np.zeros(rs_dims * C.RS_KK, dtype=np.uint8)
            errors = api.rs_check_superframe(data.astype(np.int32), 0,
                                             rs_dims, outbuf)
            ok = errors == int(ex["errors"])
            if ok and errors != -1:
                ok = bool(np.array_equal(outbuf, ex["out"]))
        else:
            ok = False
        n_ok += ok
        results.append((os.path.basename(path), kind, bool(ok)))
    return n_ok, n_total, results
