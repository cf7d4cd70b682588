"""Golden scalar models: the bit-exact oracles.

``viterbi_tpu.golden`` in numpy, importable where the port runs without
jax. Viterbi: the K=7 rate-1/4 convolutional encoder
(viterbi-benchmark.cpp:303-311) and the soft-decision decoder with the
reference's exact numerics — rounding-average branch metrics,
saturating u8 path metrics, renormalize-at-150 every two steps,
terminated-trellis chainback from state 0 (deconvolve.cpp:232-435).
Reed-Solomon: the scalar RS(120,110) decoder with the reference's
log-form bookkeeping (rschecksf.cpp:198-377), the superframe check
(rschecksf.cpp:64-93) and a systematic encoder for fixtures.
``tests/test_torch_constants.py`` and ``tests/test_torch_rs.py`` pin
them to the JAX package's golden model.
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

    ``syms4``: [..., 4] soft symbols (only the low byte is used), one
    step of one frame or of many. Returns int32[..., 32]: metric for the
    input-bit-0 branch from low predecessor ``b``; the other three
    branches of butterfly ``b`` use this metric or its complement
    63 - metric.
    """
    pol = C.branch_polarity_table() == 1                    # [4, 32]
    s = (np.asarray(syms4, dtype=np.int64) & 0xFF).astype(np.int32)
    a = np.where(pol, 255 - s[..., None], s[..., None])     # [..., 4, 32]
    m = _avg_u8(_avg_u8(a[..., 0, :], a[..., 1, :]),
                _avg_u8(a[..., 2, :], a[..., 3, :]))
    return (m >> 2) & 63


def viterbi_forward_many(framebits: int, symbols: np.ndarray):
    """Forward ACS pass over N frames at once, each exactly as
    ``viterbi_forward``. ``symbols``: [N, >= 4*(framebits+6)]. Returns
    (decisions uint8[T, N, 64], final_metrics int32[N, 64])."""
    nsteps = framebits + C.TAIL_BITS
    symbols = np.asarray(symbols)
    assert symbols.ndim == 2 and symbols.shape[1] >= C.RATE * nsteps
    n = symbols.shape[0]
    syms = (symbols[:, : C.RATE * nsteps].astype(np.int64) & 0xFF) \
        .astype(np.int32).reshape(n, nsteps, C.RATE)
    metrics = np.full((n, C.NUM_STATES), 63, dtype=np.int32)
    metrics[:, 0] = 0
    decisions = np.zeros((nsteps, n, C.NUM_STATES), dtype=np.uint8)
    sat = lambda x: np.minimum(x, C.METRIC_MAX)
    for t in range(nsteps):
        m = branch_metrics(syms[:, t])                         # [N, 32]
        cm = 63 - m
        lo, hi = metrics[:, :32], metrics[:, 32:]
        p0e, p1e = sat(lo + m), sat(hi + cm)     # into even state 2b
        p0o, p1o = sat(lo + cm), sat(hi + m)     # into odd state 2b+1
        new = np.empty_like(metrics)
        new[:, 0::2] = np.minimum(p0e, p1e)
        new[:, 1::2] = np.minimum(p0o, p1o)
        decisions[t, :, 0::2] = p1e <= p0e
        decisions[t, :, 1::2] = p1o <= p0o
        metrics = new
        if t % 2 == 1:
            high = metrics[:, :1] > C.RENORMALIZE_THRESHOLD
            metrics = np.where(high, np.maximum(metrics - C.RENORM_SUB, 0),
                               metrics)
    return decisions, metrics


def viterbi_forward(framebits: int, symbols: np.ndarray):
    """Forward ACS pass. Returns (decisions uint8[T,64], final_metrics).

    ``decisions[t, s]`` is 1 iff the survivor into new state ``s`` at
    step ``t`` came from the high predecessor (s>>1)+32; ties go to the
    high predecessor (deconvolve.cpp:247-250). Renormalization fires
    after every second step (deconvolve.cpp:398-405).
    """
    symbols = np.asarray(symbols).reshape(1, -1)
    decisions, metrics = viterbi_forward_many(framebits, symbols)
    return decisions[:, 0], metrics[0]


def chainback_many(framebits: int, decisions: np.ndarray) -> np.ndarray:
    """``chainback`` over N frames: decisions uint8[T, N, 64] ->
    uint8[N, ceil(framebits/8)]."""
    n = decisions.shape[1]
    frames = np.arange(n)
    out_bits = np.zeros((n, framebits), dtype=np.uint8)
    state = np.zeros(n, dtype=np.int64)
    for t in range(framebits - 1, -1, -1):
        k = decisions[t + C.TAIL_BITS, frames, state].astype(np.int64)
        out_bits[:, t] = k
        state = (state >> 1) | (k << 5)
    return np.packbits(out_bits, axis=1)


def chainback(framebits: int, decisions: np.ndarray) -> np.ndarray:
    """Traceback from state 0, returning MSB-first packed bytes
    (``ChainBack``, deconvolve.cpp:416-435): the decision bit of the
    current state at step t+6 is data bit t; predecessor =
    (state >> 1) | (bit << 5)."""
    return chainback_many(framebits, np.asarray(decisions)[:, None])[0]


def deconvolve_many(framebits: int, symbols: np.ndarray) -> np.ndarray:
    """Golden decode of N frames at once: [N, >= 4*(framebits+6)] ->
    uint8[N, ceil(framebits/8)], frame for frame ``deconvolve``."""
    decisions, _ = viterbi_forward_many(framebits, symbols)
    return chainback_many(framebits, decisions)


def deconvolve(framebits: int, symbols: np.ndarray) -> np.ndarray:
    """Full golden decode: uint8[ceil(framebits/8)] MSB-first packed bytes."""
    return deconvolve_many(framebits, np.asarray(symbols).reshape(1, -1))[0]


# ---------------------------------------------------------------------------
# Reed-Solomon RS(120,110) decoder (scalar, bit-exact)
# ---------------------------------------------------------------------------

_ATO_MOD, _INDEX_OF = C.gf256_tables()
_A = int(C.RS_NN)  # 255, the "log of zero" sentinel


def _gf_mul_log(log_a: int, log_b: int) -> int:
    """alpha^(log_a + log_b) via the 768-entry pre-reduced antilog table."""
    return int(_ATO_MOD[log_a + log_b])


def rs_decode_codeword(data: np.ndarray) -> tuple[int, np.ndarray]:
    """Decode one shortened RS(120,110) codeword in place.

    ``data``: int array of 120 byte values (data[0..109] message,
    data[110..119] parity). Returns ``(count, corrected)`` where count is
    the number of corrected byte errors or -1 if uncorrectable — exactly
    DECODE_RS's contract (rschecksf.cpp:198-377).
    """
    data = np.asarray(data, dtype=np.int64).copy()
    n = C.RS_N
    nroots = C.RS_NROOTS
    pad = C.RS_PAD

    # Syndromes: s_i = sum_j data[j] * alpha^(i*(n-1-j)), Horner form.
    s = np.full(nroots, int(data[0]), dtype=np.int64)
    for j in range(1, n):
        for i in range(nroots):
            if s[i] == 0:
                s[i] = data[j]
            else:
                s[i] = data[j] ^ _gf_mul_log(int(_INDEX_OF[s[i]]), i)
    if not s.any():
        return 0, data  # valid codeword, nothing to do

    slog = [int(_INDEX_OF[v]) for v in s]  # syndromes in log form

    # Berlekamp-Massey: find the error locator polynomial lambda (log form
    # bookkeeping matches the reference so intermediate values agree).
    lam = [1] + [0] * nroots          # poly form
    b = [_A] * (nroots + 1)           # log form, b(x) = 1
    b[0] = 0
    el = 0
    for r in range(1, nroots + 1):
        discr = 0
        for i in range(r):
            if lam[i] != 0 and slog[r - 1 - i] != _A:
                discr ^= _gf_mul_log(int(_INDEX_OF[lam[i]]), slog[r - 1 - i])
        dlog = int(_INDEX_OF[discr])
        if dlog == _A:  # zero discrepancy: b(x) <- x*b(x)
            b = [_A] + b[:-1]
        else:
            t = [lam[0]] + [
                lam[i + 1] ^ (_gf_mul_log(dlog, b[i]) if b[i] != _A else 0)
                for i in range(nroots)
            ]
            if 2 * el <= r - 1:
                el = r - el
                b = [(_A if lam[i] == 0 else
                      int(C.mod255(int(_INDEX_OF[lam[i]]) - dlog + _A)))
                     for i in range(nroots + 1)]
            else:
                b = [_A] + b[:-1]
            lam = t

    lam_log = [int(_INDEX_OF[v]) for v in lam]
    deg_lambda = max((i for i in range(nroots + 1) if lam_log[i] != _A),
                     default=0)

    # Chien search over the whole field, aborting once all roots found.
    reg = list(lam_log)
    roots: list[int] = []
    for i in range(1, C.RS_NN + 1):
        q = 1
        for j in range(deg_lambda, 0, -1):
            if reg[j] != _A:
                reg[j] = int(C.mod255(reg[j] + j))
                q ^= int(_ATO_MOD[reg[j]])
        if q != 0:
            continue
        roots.append(i)
        if len(roots) == deg_lambda:
            break
    if len(roots) != deg_lambda:
        return -1, data  # uncorrectable

    # Error evaluator omega(x) = s(x) * lambda(x) mod x^nroots, log form.
    deg_omega = deg_lambda - 1
    omega_log = []
    for i in range(deg_omega + 1):
        tmp = 0
        for j in range(i, -1, -1):
            if slog[i - j] != _A and lam_log[j] != _A:
                tmp ^= _gf_mul_log(slog[i - j], lam_log[j])
        omega_log.append(int(_INDEX_OF[tmp]))

    # Forney: error magnitude at each root; positions inside the shortened
    # region (root > PAD) only — earlier roots fall in the implicit zeros.
    count = len(roots)
    for root in reversed(roots):
        if root < pad + 1:
            continue
        num1 = 0
        for i in range(deg_omega, -1, -1):
            if omega_log[i] != _A:
                num1 ^= int(_ATO_MOD[int(C.mod255(omega_log[i] + i * root))])
        if num1 == 0:
            continue
        num2 = int(_ATO_MOD[C.RS_NN - root])
        den = 0
        top = min(deg_lambda, nroots - 1) & ~1
        for i in range(top, -1, -2):
            if lam_log[i + 1] != _A:
                den ^= int(_ATO_MOD[int(C.mod255(lam_log[i + 1] + i * root))])
        tmp = (int(_INDEX_OF[num1]) + int(_INDEX_OF[num2])
               + (C.RS_NN - int(_INDEX_OF[den])))
        data[root - 1 - pad] ^= int(_ATO_MOD[tmp])

    return count, data


def rs_check_superframe(p: np.ndarray, rs_dims: int) -> tuple[int, np.ndarray]:
    """Check/correct a DAB+ superframe of ``rs_dims`` interleaved codewords.

    ``p``: uint8[rs_dims * 120] byte-interleaved input (codeword j's k-th
    byte at p[j + k*rs_dims]). Returns ``(errors, out)`` with ``out`` the
    uint8[rs_dims * 110] corrected data, errors = total corrected bytes or
    -1 on the first uncorrectable codeword — RScheckSuperframe's contract
    (rschecksf.cpp:64-93).
    """
    p = np.asarray(p, dtype=np.uint8).reshape(-1)
    out = np.zeros(rs_dims * C.RS_KK, dtype=np.uint8)
    errors = 0
    for j in range(rs_dims):
        block = p[j::rs_dims][:C.RS_N].astype(np.int64)
        count, corrected = rs_decode_codeword(block)
        if count == -1:
            return -1, out
        errors += count
        out[j::rs_dims] = corrected[:C.RS_KK].astype(np.uint8)
    return errors, out


def _generator_poly() -> np.ndarray:
    """g(x) = prod_{i=0..9} (x - alpha^i); g[i] is the coefficient of x^i,
    monic with degree 10."""
    mul = C.gf256_mul_table().astype(np.int64)
    g = np.zeros(C.RS_NROOTS + 1, dtype=np.int64)
    g[0] = 1
    for i in range(C.RS_NROOTS):
        root = int(_ATO_MOD[i])
        shifted = np.concatenate([[0], g[:-1]])            # x * g(x)
        g = shifted ^ mul[g, root]                         # + alpha^i * g(x)
    return g


def rs_encode_many(messages: np.ndarray) -> np.ndarray:
    """Systematic RS(120,110) encoder over N messages at once (for
    fixtures; the reference has none): uint8[N, 110] -> uint8[N, 120].

    Appends 10 parity bytes so each 120-byte word evaluates to zero at
    alpha^0..alpha^9 in the padded RS(255,245) sense of the decoder's
    Horner syndrome loop. LFSR long division, one message byte per round
    for all N words; the remainder holds x^9..x^0, high order first.
    """
    msg = np.asarray(messages, dtype=np.int64).reshape(-1, C.RS_KK)
    mul = C.gf256_mul_table().astype(np.int64)
    taps = _generator_poly()[:C.RS_NROOTS][::-1]
    rem = np.zeros((msg.shape[0], C.RS_NROOTS), dtype=np.int64)
    for j in range(C.RS_KK):
        fb = rem[:, 0] ^ msg[:, j]
        rem = np.concatenate([rem[:, 1:], np.zeros_like(rem[:, :1])], axis=1)
        rem ^= mul[taps[None, :], fb[:, None]]         # mul[., 0] == 0
    return np.concatenate([msg, rem], axis=1).astype(np.uint8)


def rs_encode_codeword(message: np.ndarray) -> np.ndarray:
    """``rs_encode_many`` for one message: uint8[110] -> uint8[120]."""
    return rs_encode_many(np.asarray(message).reshape(1, C.RS_KK))[0]
