"""Plain reference Viterbi decoder: the K=7 rate-1/4 DAB mother code with
the reference DLL's numerics, in plain torch on any device.

Written from the reference's description (viterbi-benchmark.cpp:54-64,
deconvolve.cpp:232-435, chainback.inc:18-41), not from the program under
test, and importing nothing of it:

* branch metrics: each of the four soft symbols' low byte, complemented
  where the expected bit is 1, then the rounding average of the rounding
  averages of the pairs (``pavgb``), shifted right by 2: a 6-bit metric
  for the input-bit-0 branch of a butterfly; the other three branches use
  it or 63 minus it;
* path metrics saturate at 255; ties go to the high predecessor;
* after every second step, if state 0's metric exceeds 150, 63 is taken
  from every metric (saturating at 0);
* the trellis is terminated (6 zero tail bits) and the traceback starts
  at state 0; the decoded bits are packed MSB first.

``decode`` takes a [N, >= 4*(framebits+6)] integer tensor and returns
uint8[N, framebits // 8] on the symbols' device. ``soft_bits`` keeps only
the top bits of each symbol: the benchmark's control (a decoder fed
coarser soft symbols), never used for the reference itself.
"""

from __future__ import annotations

import torch

K = 7
NUM_STATES = 64
RATE = 4
POLYS = (109, 79, 83, 109)
TAIL_BITS = K - 1
METRIC_MAX = 255
RENORM_ABOVE = 150
RENORM_SUB = 63
#: bytes of branch-metric temporaries made in one go
_BM_BYTES = 1 << 29
#: decision bytes held at once (rows are decoded in blocks below this)
_DECISION_BYTES = 4 << 30


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


def polarity(device) -> torch.Tensor:
    """bool[4, 32]: expected symbol j of butterfly b's input-bit-0 branch
    from low predecessor b (next state 2b): parity((b << 1) & POLYS[j])."""
    pol = [[_parity((b << 1) & p) for b in range(NUM_STATES // 2)]
           for p in POLYS]
    return torch.tensor(pol, dtype=torch.bool, device=device)


def _avg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a + b + 1) >> 1


def branch_metrics(syms: torch.Tensor, pol: torch.Tensor) -> torch.Tensor:
    """[N, T, 4] soft symbols -> int32[N, T, 32] branch metrics."""
    s = (syms & 255).to(torch.int32)[..., None]               # [N, T, 4, 1]
    a = torch.where(pol, 255 - s, s)                          # [N, T, 4, 32]
    m = _avg(_avg(a[..., 0, :], a[..., 1, :]),
             _avg(a[..., 2, :], a[..., 3, :]))
    return (m >> 2) & 63


def soft_bits(symbols: torch.Tensor, bits: int) -> torch.Tensor:
    """Symbols with only their top ``bits`` of 8 kept (the low ones 0)."""
    mask = (0xFF << (8 - bits)) & 0xFF
    return (symbols & 255) & mask


def _decode_block(syms: torch.Tensor, framebits: int) -> torch.Tensor:
    n, nsteps = syms.shape[0], framebits + TAIL_BITS
    dev = syms.device
    pol = polarity(dev)
    s = syms[:, :RATE * nsteps].reshape(n, nsteps, RATE)
    metrics = torch.full((n, NUM_STATES), 63, dtype=torch.int32, device=dev)
    metrics[:, 0] = 0
    decisions = torch.empty((nsteps, n, NUM_STATES), dtype=torch.bool,
                            device=dev)
    chunk = max(1, _BM_BYTES // (n * RATE * 32 * 4))
    for c0 in range(0, nsteps, chunk):
        bm = branch_metrics(s[:, c0:c0 + chunk], pol)
        for i in range(bm.shape[1]):
            t = c0 + i
            m = bm[:, i]
            cm = 63 - m
            lo, hi = metrics[:, :32], metrics[:, 32:]
            p0e = torch.clamp(lo + m, max=METRIC_MAX)
            p1e = torch.clamp(hi + cm, max=METRIC_MAX)
            p0o = torch.clamp(lo + cm, max=METRIC_MAX)
            p1o = torch.clamp(hi + m, max=METRIC_MAX)
            metrics = torch.stack((torch.minimum(p0e, p1e),
                                   torch.minimum(p0o, p1o)), dim=2) \
                .reshape(n, NUM_STATES)
            decisions[t] = torch.stack((p1e <= p0e, p1o <= p0o), dim=2) \
                .reshape(n, NUM_STATES)
            if t % 2 == 1:
                high = metrics[:, :1] > RENORM_ABOVE
                metrics = torch.where(
                    high, torch.clamp(metrics - RENORM_SUB, min=0), metrics)
    rows = torch.arange(n, device=dev)
    state = torch.zeros(n, dtype=torch.int64, device=dev)
    bits = torch.empty((n, framebits), dtype=torch.int64, device=dev)
    for t in range(framebits - 1, -1, -1):
        k = decisions[t + TAIL_BITS, rows, state].to(torch.int64)
        bits[:, t] = k
        state = (state >> 1) | (k << 5)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=dev)
    return (bits.reshape(n, framebits // 8, 8) * weights).sum(dim=2) \
        .to(torch.uint8)


def decode(symbols: torch.Tensor, framebits: int) -> torch.Tensor:
    """Decode N terminated frames: [N, >= 4*(framebits+6)] integer soft
    symbols -> uint8[N, framebits // 8], MSB first."""
    if framebits % 8:
        raise ValueError(f"framebits must be a multiple of 8, got {framebits}")
    n = symbols.shape[0]
    rows = max(1, _DECISION_BYTES // ((framebits + TAIL_BITS) * NUM_STATES))
    return torch.cat([_decode_block(symbols[i:i + rows], framebits)
                      for i in range(0, n, rows)]) if n else \
        torch.empty((0, framebits // 8), dtype=torch.uint8,
                    device=symbols.device)
