"""Batched Viterbi forward pass (add-compare-select) in plain torch.

The port of ``viterbi_tpu.ops.acs``: a [B, 64]-shaped vectorized
butterfly stepped over trellis time in a Python loop. It is the
``torch_scan`` rung's forward pass and the oracle the kernels are held
against at batch sizes the golden model cannot reach. It runs on
whatever device its input lies on.

Trellis-step contract:
  * branch metric for butterfly b (predecessor states b and b+32, new
    states 2b / 2b+1): a_j = pol[j,b] ? 255 - s_j : s_j,
    metric = (avg(avg(a_0,a_1), avg(a_2,a_3)) >> 2) & 63,
    avg(x,y) = (x+y+1) >> 1
  * ACS with saturating adds (cap 255), min survivor; decision = 1 iff
    the high-predecessor path wins, ties to 1
  * renormalize after every 2nd step: if metric[state 0] > 150,
    subtract 63 from all metrics with a floor at 0
  * initial metrics: state 0 -> 0, others -> 63.

Decisions are two words per (step, frame), bit s of word s//32 being
the decision into new state s (the reference's ``decision_t``,
viterbi.h:89-92), kept as int32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C

_POL = np.asarray(C.branch_polarity_table(), dtype=np.int32)   # [4, 32]


def branch_metrics(syms4: torch.Tensor) -> torch.Tensor:
    """Branch metrics for one step. syms4: [..., 4] int -> [..., 32] int32."""
    s = (syms4.to(torch.int32) & 0xFF).unsqueeze(-1)              # [..., 4, 1]
    pol = torch.as_tensor(_POL, device=syms4.device)              # [4, 32]
    a = torch.where(pol != 0, 255 - s, s)                         # [..., 4, 32]
    avg = lambda x, y: (x + y + 1) >> 1
    m = avg(avg(a[..., 0, :], a[..., 1, :]), avg(a[..., 2, :], a[..., 3, :]))
    return (m >> 2) & 63


def acs_step(metrics: torch.Tensor, m: torch.Tensor, saturate: bool = True):
    """One trellis step. metrics: [B, 64], m: [B, 32] branch metrics.

    Returns (new_metrics [B, 64], decisions [B, 64] bool). The adds
    saturate at 255 unless ``saturate`` is off (the ablation probe).
    """
    cm = 63 - m
    lo, hi = metrics[:, :32], metrics[:, 32:]
    p0e, p1e, p0o, p1o = lo + m, hi + cm, lo + cm, hi + m
    if saturate:
        p0e, p1e, p0o, p1o = (torch.clamp_max(p, C.METRIC_MAX)
                              for p in (p0e, p1e, p0o, p1o))
    new = torch.stack([torch.minimum(p0e, p1e), torch.minimum(p0o, p1o)],
                      dim=-1).reshape(metrics.shape)
    dec = torch.stack([p1e <= p0e, p1o <= p0o], dim=-1).reshape(metrics.shape)
    return new, dec


def renormalize(metrics: torch.Tensor) -> torch.Tensor:
    """Subtract 63 (floor 0) from every metric of frames whose state-0
    metric is above the threshold."""
    sub = (metrics[:, :1] > C.RENORMALIZE_THRESHOLD).to(metrics.dtype) \
        * C.RENORM_SUB
    return torch.clamp_min(metrics - sub, 0)


def pack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """Pack [B, 64] bools into [B, 2] int32 decision words (bit patterns)."""
    weights = torch.ones(32, dtype=torch.int64, device=dec.device) \
        << torch.arange(32, device=dec.device)
    words = (dec.reshape(-1, 2, 32).to(torch.int64) * weights).sum(-1)
    # fold [0, 2^32) into int32's range: the same 32 bits
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def init_metrics(batch: int, device) -> torch.Tensor:
    m = torch.full((batch, C.NUM_STATES), 63, dtype=torch.int32,
                   device=device)
    m[:, 0] = 0
    return m


def forward(symbols: torch.Tensor, nsteps: int,
            initial_metrics: torch.Tensor | None = None):
    """Run ``nsteps`` trellis steps over a batch of symbol streams.

    ``symbols``: [B, >=4*nsteps] int soft symbols (low byte significant).
    Returns (decisions int32[nsteps, B, 2], final_metrics int32[B, 64]).

    ``nsteps`` must be even so the renormalization cadence of the
    reference's 2-steps-per-iteration main loop is preserved.
    """
    assert nsteps % 2 == 0, "nsteps must be even (renormalization cadence)"
    B = symbols.shape[0]
    syms = symbols[:, : C.RATE * nsteps].to(torch.int32) \
        .reshape(B, nsteps, C.RATE)
    if initial_metrics is None:
        metrics = init_metrics(B, symbols.device)
    else:
        metrics = initial_metrics.to(device=symbols.device,
                                     dtype=torch.int32)
    decisions = torch.empty((nsteps, B, 2), dtype=torch.int32,
                            device=symbols.device)
    for t in range(nsteps):
        metrics, dec = acs_step(metrics, branch_metrics(syms[:, t]))
        decisions[t] = pack_decisions(dec)
        if t % 2 == 1:
            metrics = renormalize(metrics)
    return decisions, metrics
