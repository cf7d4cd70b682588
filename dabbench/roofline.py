"""The least time the card could take for a kernel's work: frozen copies
of the counts the program's bring-up check used, so that the yardstick
cannot move with the program.

Copied from ``chip_smoke.py`` (``bound``, the operation counts of kernel
A, ``rs_decoder_ops``) and ``viterbi_tpu_torch/ops/rs.py``
(``decoder_work``) at commit 7d07b678fb927d24a3ae9bba69ca509c72acf088.
``decoder_work`` is recomputed here through the plain reference's
decoder (``reference/rs.py``), not the program's.

The peaks are the card's published ones (NVIDIA's H100 SXM data sheet):
3.35 TB/s of HBM, 132 SMs issuing 64 int32 operations a clock at the
card's highest SM clock (``nvidia-smi --query-gpu=clocks.max.sm``), and
1979 T dense int8 tensor operations/s. They assume the full 700 W; the
card's power limit is printed beside every share (``card.stamp``).
"""

from __future__ import annotations

import torch

from .reference import rs as ref_rs

HBM_BYTES_S = 3.35e12
SMS = 132
INT_LANES = 64
INT8_TENSOR_OPS_S = 1979e12
TAIL_BITS = 6
NUM_STATES = 64

# Kernel A (csrc/acs_regs.cu): integer operations a trellis step and frame,
# the shortest sequence the card has (chip_smoke.py's count): branch
# metrics 36 + 4 to unpack + 8 complements, renormalisation 32.5 a step,
# 10 a butterfly for the 32 butterflies, the registers' shift 64/6.
BRANCH_METRIC_OPS = 4 + 8 * 2 + 8 * 2
STEP_COMMON_OPS = BRANCH_METRIC_OPS + 4 + 8 + 32.5
OPS_PER_STEP_A = 32 * 10 + 64 / 6 + STEP_COMMON_OPS
#: kernel A's checkpoint period on the decode path (ops.acs_cuda.DECODE_CKPT)
DECODE_CKPT = 24

# Kernel I (csrc/rs_decode.cu): syndromes as the 960 x 80 GF(2) product on
# the tensor cores; a dirty codeword's Berlekamp-Massey (990), its Chien
# search (3 a term an element visited), omega (4 a product) and Forney.
OPS_RS_SYND_TENSOR = 2 * 960 * 80
OPS_RS_BM = 990
OPS_RS_TERM = 3
OPS_RS_PRODUCT = 4
OPS_RS_VALUE = 5


def bound(nbytes: float, int_ops: float, clock_hz: float,
          tensor_ops: float = 0.0) -> float:
    """Seconds: the larger of the bytes over the memory rate and the
    operations over their pipe's issue rate."""
    by_bytes = nbytes / HBM_BYTES_S
    by_ops = max(int_ops / (INT_LANES * SMS * clock_hz),
                 tensor_ops / INT8_TENSOR_OPS_S)
    return max(by_bytes, by_ops)


def acs_regs_bound(frames: int, framebits: int, clock_hz: float,
                   symbol_bytes: int = 16) -> float:
    """Kernel A on ``frames`` frames read as unpacked int32 symbols (16
    bytes a step): the symbols read once, the checkpoints written, the
    initial and final metrics; the operations of every step."""
    n = framebits + TAIL_BITS
    ck = -(-n // DECODE_CKPT)
    state_bytes = frames * NUM_STATES * 4
    return bound(frames * n * symbol_bytes + (ck + 2) * state_bytes,
                 frames * n * OPS_PER_STEP_A, clock_hz)


def decoder_work(cw: torch.Tensor) -> dict:
    """What the reference's scalar decoder does beyond the syndromes on
    each codeword [B, 120]: ``dirty``, ``deg_lambda``, ``terms`` (the
    locator's nonzero coefficients past the first), ``chien`` (elements
    the search visits: up to its last root, or all 255),
    ``correctable``, ``forney`` (roots past the pad)."""
    cw = cw.to(torch.int64)
    B = cw.shape[0]
    s = ref_rs.syndromes(cw)
    dirty = (s != 0).any(dim=1)
    zeros = torch.zeros(B, dtype=torch.int64, device=cw.device)
    work = {"dirty": dirty, "deg_lambda": zeros.clone(),
            "terms": zeros.clone(), "chien": zeros.clone(),
            "correctable": torch.zeros_like(dirty),
            "forney": zeros.clone()}
    idx = torch.nonzero(dirty).flatten()
    if idx.numel():
        lam, deg, is_root = ref_rs.locate(s[idx])
        n_roots = is_root.sum(dim=1)
        i_all = torch.arange(1, ref_rs.NN + 1, device=cw.device)
        last = torch.where(is_root, i_all, 0).amax(dim=1)
        ok = n_roots == deg
        work["deg_lambda"][idx] = deg
        work["terms"][idx] = (lam[:, 1:] != 0).sum(dim=1)
        work["chien"][idx] = torch.where(ok, last, ref_rs.NN)
        work["correctable"][idx] = ok
        work["forney"][idx] = torch.where(
            ok, (is_root & (i_all > ref_rs.PAD)).sum(dim=1), 0)
    return work


def rs_superframes_bound(sf: torch.Tensor, rs_dims: int,
                         clock_hz: float) -> float:
    """Kernel I on uint8 superframes [G, rs_dims*120]: each byte read once,
    the audio and two int32 results written once; the syndromes on the
    tensor cores and the dirty codewords' operations on the int32 lanes."""
    G = sf.shape[0]
    cw = sf.reshape(G, ref_rs.N, rs_dims).transpose(1, 2) \
        .reshape(-1, ref_rs.N)
    w = decoder_work(cw)
    d = w["deg_lambda"]
    den_terms = (d.clamp(max=9) & ~1) // 2 + 1
    dirty = ((w["dirty"] * (OPS_RS_BM + OPS_RS_TERM * w["chien"]
                            * w["terms"])).sum()
             + (w["correctable"] * OPS_RS_PRODUCT * d * (d + 1) // 2).sum()
             + (w["forney"] * (OPS_RS_TERM * (d + den_terms)
                               + OPS_RS_VALUE)).sum())
    n = cw.shape[0]
    return bound(n * (ref_rs.N + ref_rs.KK) + G * 8, float(dirty), clock_hz,
                 tensor_ops=n * OPS_RS_SYND_TENSOR)
