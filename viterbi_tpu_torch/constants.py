"""L0: trellis / Galois-field constant tables, derived from first principles.

The port's numpy-only copy of ``viterbi_tpu.constants`` (the JAX package
cannot be imported where the port runs: its package import pulls in jax).
``tests/test_torch_constants.py`` pins every table to the JAX package's.

DAB mother code (reference: viterbi-benchmark.cpp:54-64):
  * constraint length K = 7  ->  64 trellis states
  * rate 1/4, generator polynomials {109, 79, 83, 109} (g0 == g3)
  * encoder: ``sr = (sr << 1) | bit; sym_j = parity(sr & poly_j)``

RS(120,110) over GF(256) (reference: viterbi.h:94-105, rschecksf.cpp:45):
  * field generator polynomial 285 (0x11D), nn = 255, 10 parity roots,
    FCR = 0, shortened by PAD = 135 bytes.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Convolutional code parameters
# ---------------------------------------------------------------------------

K = 7                       # constraint length
NUM_STATES = 64             # 2**(K-1)
RATE = 4                    # symbols per trellis step (rate 1/4)
POLYS = (109, 79, 83, 109)  # generator polynomials, g0 == g3
TAIL_BITS = K - 1           # 6 zero flush bits terminate the trellis
MAX_FRAMEBITS = 384 * 24    # 9216: max DAB bitrate 384 kbit/s * 24 ms frame

# Renormalization threshold: when state 0's metric exceeds this after a
# 2-step iteration, 63 is (saturating-)subtracted from every metric.
# Reference: viterbi.h:86, deconvolve.cpp:398-405. Must stay < 180.
RENORMALIZE_THRESHOLD = 150
RENORM_SUB = 63
METRIC_MAX = 255            # metrics saturate at u8 max


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


def branch_polarity_table() -> np.ndarray:
    """Polarity of the expected symbol per butterfly and symbol index.

    Returns ``pol`` with shape [RATE, 32], dtype uint8, values in {0, 1}:
        pol[j, b] = parity((b << 1) & POLYS[j])
    the expected symbol bit for the transition from predecessor state
    ``b`` (0..31) with input bit 0, for generator ``j``. The branch
    metric (deconvolve.cpp:232-246) is then
        a_j = pol[j, b] ? (255 - s_j) : s_j
        metric_b = (avg(avg(a_0, a_1), avg(a_2, a_3)) >> 2) & 63
    with avg(x, y) = (x + y + 1) >> 1 (rounding ``pavgb``). Every
    polynomial has bits 0 and 6 set, so one metric per butterfly and its
    complement 63 - metric cover all four branches.
    """
    pol = np.zeros((RATE, NUM_STATES // 2), dtype=np.uint8)
    for j, poly in enumerate(POLYS):
        for b in range(NUM_STATES // 2):
            pol[j, b] = _parity((b << 1) & poly)
    return pol


def expected_symbols_table() -> np.ndarray:
    """Expected symbol bits for every (state, input) transition.

    Returns shape [NUM_STATES, 2, RATE] uint8: entry [s, u, j] is
    parity(((s << 1) | u) & POLYS[j]).
    """
    tbl = np.zeros((NUM_STATES, 2, RATE), dtype=np.uint8)
    for s in range(NUM_STATES):
        for u in (0, 1):
            r = (s << 1) | u
            for j, poly in enumerate(POLYS):
                tbl[s, u, j] = _parity(r & poly)
    return tbl


# ---------------------------------------------------------------------------
# Reed-Solomon / GF(256) parameters
# ---------------------------------------------------------------------------

RS_NN = 255        # c_nn
RS_GFPOLY = 285    # c_gfpoly (0x11D)
RS_NROOTS = 10     # c_nroots: parity symbols per codeword
RS_PAD = 135       # shortening pad: RS(255,245) -> RS(120,110)
RS_N = RS_NN - RS_PAD          # 120: bytes per (shortened) codeword
RS_KK = RS_N - RS_NROOTS       # 110: data bytes per codeword
ATO_MOD_SIZE = 768             # pre-reduced antilog table length


def gf256_tables() -> tuple[np.ndarray, np.ndarray]:
    """GF(256) log/antilog tables, exactly as the reference builds them.

    Returns ``(ato_mod, index_of)``:
      * ``index_of``: uint8[256] log table, index_of[0] == 255 (log of zero)
      * ``ato_mod``:  uint8[768] antilog table pre-reduced mod 255
        (``ato_mod[x] = alpha_to[x % 255]``) — dllmain.cpp:124-150.
    """
    index_of = np.zeros(256, dtype=np.uint8)
    alpha_to = np.zeros(256, dtype=np.uint8)
    index_of[0] = RS_NN
    alpha_to[RS_NN] = 0
    sr = 1
    for i in range(RS_NN):
        index_of[sr] = i
        alpha_to[i] = sr
        sr <<= 1
        if sr & 256:
            sr ^= RS_GFPOLY
        sr &= RS_NN
    ato_mod = np.array([alpha_to[i % 255] for i in range(ATO_MOD_SIZE)],
                       dtype=np.uint8)
    return ato_mod, index_of


def gf256_mul_table() -> np.ndarray:
    """Full 256x256 GF(256) multiplication table (uint8)."""
    ato_mod, index_of = gf256_tables()
    a = np.arange(256, dtype=np.int32)
    log_a = index_of[a].astype(np.int32)
    prod = ato_mod[log_a[:, None] + log_a[None, :]]  # sums <= 509 < 768
    # zero annihilates: log(0) == 255 indexes garbage antilog slots
    prod = np.where((a[:, None] == 0) | (a[None, :] == 0), 0, prod)
    return prod.astype(np.uint8)


def mod255(x: np.ndarray | int):
    """Branch-free x % 255, valid for 0 <= x < 66299 (rschecksf.cpp:48-52),
    with the reference's uint32 wrap before the shift."""
    prod = (np.uint64(x) * np.uint64(0x1010102)) & np.uint64(0xFFFFFFFF)
    return prod >> np.uint64(24)
