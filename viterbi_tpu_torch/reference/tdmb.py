"""Plain reference of the T-DMB stream-mode chain: what
``models.tdmb.decode_ts_streams`` must give, written from the standards
and kept apart from the port: the puncturing of ``reference.punctured``,
the golden scalar Viterbi decode (``golden.py``), and here, one byte and
one codeword at a time in plain Python, the outer interleaver and
RS(204,188); no op, kernel or placement code of the port.

* The outer code (ETSI EN 300 744 clause 4.3.2, which ETSI TS 102 427
  applies to a transport stream in a DAB stream-mode subchannel):
  RS(204,188, t = 8), shortened from RS(255,239) by 51 leading zero
  bytes; field generator p(x) = x^8 + x^4 + x^3 + x^2 + 1, code
  generator g(x) = (x + l^0)(x + l^1) ... (x + l^15), l = 02h; byte j of
  a codeword the coefficient of x^(203 - j).
* Its decoding, the textbook bounded-distance rule: syndromes S_i =
  r(l^i), i = 0 .. 15, all zero: count 0; Berlekamp-Massey (Massey's
  form) gives Lambda of degree nu, nu > 8: -1; the Chien search over the
  204 sent positions only (position p is l^-(203 - p), a root l^(p + 52)
  of Lambda), -1 unless the distinct roots number nu; Forney with the
  first root l^0, e = X Omega(X^-1) / Lambda'(X^-1), Omega = S Lambda mod
  x^16, -1 where any e is 0; a -1 codeword comes back as received; else
  the count is nu.
* The interleaver (clause 4.3.2, figure 6): I = 12 branches, M = 17;
  byte n takes branch n mod 12, in the transmitter a FIFO of j * 17
  cells, in the receiver of (11 - j) * 17, each shifting once a use. A
  fresh FIFO holds zeros. The receiver's state is its FIFOs, 1122 bytes
  a stream: branch 0's cells first, each branch oldest first.
* A stream at 68 p kbit/s carries p packets a 24 ms logical frame; its
  decoded frames, in order, are the interleaved stream, aligned to its
  first frame; no sync search, no DVB randomiser.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import golden
from . import punctured as P

N, K, NROOTS, T = 204, 188, 16, 8
PAD = 255 - N
BRANCHES, DEPTH = 12, 17
CARRY = DEPTH * BRANCHES * (BRANCHES - 1) // 2


def _field():
    exp, log = [0] * 512, [0] * 256
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    return exp, log


EXP, LOG = _field()


def gmul(a: int, b: int) -> int:
    return 0 if a == 0 or b == 0 else EXP[LOG[a] + LOG[b]]


def gdiv(a: int, b: int) -> int:
    return 0 if a == 0 else EXP[LOG[a] + 255 - LOG[b]]


def gpow(e: int) -> int:
    return EXP[e % 255]


def poly_eval(coeffs, x: int) -> int:
    """coeffs[k] the coefficient of x^k."""
    out, xp = 0, 1
    for c in coeffs:
        out ^= gmul(c, xp)
        xp = gmul(xp, x)
    return out


def generator() -> list:
    """g(x), g[k] the coefficient of x^k, degree 16."""
    g = [1]
    for i in range(NROOTS):
        r = gpow(i)
        nxt = [0] * (len(g) + 1)
        for k, c in enumerate(g):
            nxt[k + 1] ^= c
            nxt[k] ^= gmul(c, r)
        g = nxt
    return g


def rs_encode(msg) -> np.ndarray:
    """188 message bytes -> the 204-byte systematic codeword: the message,
    then the remainder of m(x) x^16 by g(x)."""
    g = generator()
    rem = [0] * NROOTS                  # rem[k]: coefficient of x^(15 - k)
    for byte in msg:
        fb = int(byte) ^ rem[0]
        rem = rem[1:] + [0]
        for k in range(NROOTS):
            rem[k] ^= gmul(fb, g[NROOTS - 1 - k])
    return np.concatenate([np.asarray(msg, np.uint8),
                           np.array(rem, np.uint8)])


def decode_codeword(received) -> tuple[int, np.ndarray]:
    """(count, corrected 188 data bytes) of one received codeword."""
    r = [int(v) for v in received]
    # r(x) with r[j] at x^(203 - j)
    coeffs = r[::-1]
    s = [poly_eval(coeffs, gpow(i)) for i in range(NROOTS)]
    if not any(s):
        return 0, np.array(r[:K], np.uint8)
    fail = (-1, np.array(r[:K], np.uint8))
    # Berlekamp-Massey
    lam, b, el = [1] + [0] * NROOTS, [1] + [0] * NROOTS, 0
    for n in range(1, NROOTS + 1):
        d = 0
        for i in range(n):
            d ^= gmul(lam[i], s[n - 1 - i])
        xb = [0] + b[:-1]
        if d == 0:
            b = xb
            continue
        new = [lam[k] ^ gmul(d, xb[k]) for k in range(NROOTS + 1)]
        if 2 * el <= n - 1:
            b = [gdiv(c, d) for c in lam]
            el = n - el
        else:
            b = xb
        lam = new
    nu = max(k for k in range(NROOTS + 1) if lam[k])
    if nu > T:
        return fail
    # Chien over the sent positions: X_p = l^(203 - p), root X_p^-1
    positions = [p for p in range(N) if poly_eval(lam, gpow(p + PAD + 1))
                 == 0]
    if len(positions) != nu:
        return fail
    omega = [0] * NROOTS
    for i in range(NROOTS):
        for k in range(i + 1):
            omega[i] ^= gmul(s[i - k], lam[k])
    deriv = [lam[k] if k % 2 else 0 for k in range(1, NROOTS + 1)]
    out = list(r)
    for p in positions:
        xinv = gpow(p + PAD + 1)
        x = gdiv(1, xinv)
        e = gdiv(gmul(x, poly_eval(omega, xinv)), poly_eval(deriv, xinv))
        if e == 0:
            return fail
        out[p] ^= e
    return nu, np.array(out[:K], np.uint8)


def interleave(stream) -> np.ndarray:
    """The transmitter's interleaver from zero FIFOs over one stream's
    bytes (a multiple of 12)."""
    fifos = [[0] * (j * DEPTH) for j in range(BRANCHES)]
    out = np.empty(len(stream), np.uint8)
    for n, v in enumerate(stream):
        f = fifos[n % BRANCHES]
        f.append(int(v))
        out[n] = f.pop(0)
    return out


def deinterleave(stream, carry=None) -> tuple[np.ndarray, np.ndarray]:
    """The receiver's deinterleaver over one stream's bytes, from its
    FIFOs ``carry`` (1122 bytes; None: zeros) -> (bytes, FIFOs)."""
    carry = np.zeros(CARRY, np.uint8) if carry is None else carry
    fifos, at = [], 0
    for j in range(BRANCHES):
        depth = (BRANCHES - 1 - j) * DEPTH
        fifos.append([int(v) for v in carry[at:at + depth]])
        at += depth
    out = np.empty(len(stream), np.uint8)
    for n, v in enumerate(stream):
        f = fifos[n % BRANCHES]
        f.append(int(v))
        out[n] = f.pop(0)
    return out, np.array([v for f in fifos for v in f], np.uint8)


def decode_ts_streams(received, bitrate_kbps: int, protection=("A", 3),
                      state=None):
    """The chain on int[S, T, kept] punctured soft symbols (low bytes
    count) -> (packets uint8[S, T p, 188], errors int32[S, T p], state
    uint8[S, 1122]) as CPU tensors; ``state`` the previous call's, None
    for fresh streams."""
    framebits = 24 * bitrate_kbps
    p = framebits // 8 // N
    rec = torch.as_tensor(np.asarray(received)).to(torch.int64) & 255
    S, Tc = rec.shape[0], rec.shape[1]
    full = P.depuncture(rec, P.mask(bitrate_kbps, protection))
    frames = golden.deconvolve_many(
        framebits, full.reshape(S * Tc, -1).numpy()).reshape(S, -1)
    packets = np.zeros((S, Tc * p, K), np.uint8)
    errors = np.zeros((S, Tc * p), np.int32)
    carries = np.zeros((S, CARRY), np.uint8)
    for s in range(S):
        cws, carries[s] = deinterleave(
            frames[s], None if state is None else np.asarray(state[s]))
        for m, cw in enumerate(cws.reshape(-1, N)):
            errors[s, m], packets[s, m] = decode_codeword(cw)
    return (torch.from_numpy(packets), torch.from_numpy(errors),
            torch.from_numpy(carries))
