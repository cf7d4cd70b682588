"""Golden scalar model of the Viterbi decoder: the bit-exact oracle.

The Viterbi half of ``viterbi_tpu.golden`` in numpy, importable where the
port runs without jax: the K=7 rate-1/4 convolutional encoder
(viterbi-benchmark.cpp:303-311) and the soft-decision decoder with the
reference's exact numerics — rounding-average branch metrics,
saturating u8 path metrics, renormalize-at-150 every two steps,
terminated-trellis chainback from state 0 (deconvolve.cpp:232-435).
``tests/test_torch_constants.py`` pins it to the JAX package's golden.
"""

from __future__ import annotations

import numpy as np

from . import constants as C


def encode(bits: np.ndarray) -> np.ndarray:
    """Encode data bits -> hard symbols in {0,1}.

    ``bits``: uint8[framebits] data bits. Returns uint8[4*(framebits+6)]:
    rate-1/4 symbols including the 6 zero flush (tail) bits.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    padded = np.concatenate([bits, np.zeros(C.TAIL_BITS, dtype=np.uint8)])
    out = np.empty(C.RATE * len(padded), dtype=np.uint8)
    sr = 0
    for i, b in enumerate(padded):
        sr = ((sr << 1) | int(b)) & 0x7F
        for j, poly in enumerate(C.POLYS):
            out[C.RATE * i + j] = bin(sr & poly).count("1") & 1
    return out


def hard_to_soft(symbols: np.ndarray) -> np.ndarray:
    """Map hard symbols {0,1} to ideal soft values {0, 255} (offset-binary)."""
    return np.where(np.asarray(symbols) != 0, 255, 0).astype(np.uint32)


def _avg_u8(a, b):
    """Rounding average, the ``pavgb`` semantics: (a + b + 1) >> 1."""
    return (a.astype(np.int32) + b.astype(np.int32) + 1) >> 1


def branch_metrics(syms4: np.ndarray) -> np.ndarray:
    """Per-butterfly branch metrics for one trellis step.

    ``syms4``: 4 soft symbols (only the low byte is used). Returns
    int32[32]: metric for the input-bit-0 branch from low predecessor
    ``b``; the other three branches of butterfly ``b`` use this metric
    or its complement 63 - metric.
    """
    pol = C.branch_polarity_table().astype(np.int32)       # [4, 32]
    s = (np.asarray(syms4, dtype=np.int64) & 0xFF).astype(np.int32)
    a = np.where(pol == 1, 255 - s[:, None], s[:, None])    # [4, 32]
    m = _avg_u8(_avg_u8(a[0], a[1]), _avg_u8(a[2], a[3]))
    return (m >> 2) & 63


def viterbi_forward(framebits: int, symbols: np.ndarray):
    """Forward ACS pass. Returns (decisions uint8[T,64], final_metrics).

    ``decisions[t, s]`` is 1 iff the survivor into new state ``s`` at
    step ``t`` came from the high predecessor (s>>1)+32; ties go to the
    high predecessor (deconvolve.cpp:247-250). Renormalization fires
    after every second step (deconvolve.cpp:398-405).
    """
    nsteps = framebits + C.TAIL_BITS
    symbols = np.asarray(symbols).reshape(-1)
    assert len(symbols) >= C.RATE * nsteps
    metrics = np.full(C.NUM_STATES, 63, dtype=np.int32)
    metrics[0] = 0
    decisions = np.zeros((nsteps, C.NUM_STATES), dtype=np.uint8)
    for t in range(nsteps):
        m = branch_metrics(symbols[C.RATE * t: C.RATE * (t + 1)])
        cm = 63 - m
        lo, hi = metrics[:32], metrics[32:]
        sat = lambda x: np.minimum(x, C.METRIC_MAX)
        p0e, p1e = sat(lo + m), sat(hi + cm)     # into even state 2b
        p0o, p1o = sat(lo + cm), sat(hi + m)     # into odd state 2b+1
        new = np.empty_like(metrics)
        new[0::2] = np.minimum(p0e, p1e)
        new[1::2] = np.minimum(p0o, p1o)
        decisions[t, 0::2] = (p1e <= p0e)
        decisions[t, 1::2] = (p1o <= p0o)
        metrics = new
        if t % 2 == 1 and metrics[0] > C.RENORMALIZE_THRESHOLD:
            metrics = np.maximum(metrics - C.RENORM_SUB, 0)
    return decisions, metrics


def chainback(framebits: int, decisions: np.ndarray) -> np.ndarray:
    """Traceback from state 0, returning MSB-first packed bytes
    (``ChainBack``, deconvolve.cpp:416-435): the decision bit of the
    current state at step t+6 is data bit t; predecessor =
    (state >> 1) | (bit << 5)."""
    out_bits = np.zeros(framebits, dtype=np.uint8)
    state = 0
    for t in range(framebits - 1, -1, -1):
        k = int(decisions[t + C.TAIL_BITS, state])
        out_bits[t] = k
        state = (state >> 1) | (k << 5)
    return np.packbits(out_bits)


def deconvolve(framebits: int, symbols: np.ndarray) -> np.ndarray:
    """Full golden decode: uint8[ceil(framebits/8)] MSB-first packed bytes."""
    decisions, _ = viterbi_forward(framebits, symbols)
    return chainback(framebits, decisions)
