"""Plain reference of the T-DMB stream-mode outer layer: the RS(204,188)
code and the I = 12, M = 17 convolutional byte interleaver of ETSI EN 300
744 clause 4.3.2, which ETSI TS 102 427 puts around an MPEG-2 transport
stream in a DAB stream-mode subchannel. Plain torch on any device.

Written from the standards, not from the program under test, and
importing nothing of it.

The code (EN 300 744 4.3.2): RS(204,188, t = 8), shortened from
RS(255,239) by 51 leading zero bytes; field generator x^8 + x^4 + x^3 +
x^2 + 1 (0x11D), code generator (x + l^0)(x + l^1) ... (x + l^15) with
l = 02h. Byte j of a codeword is the coefficient of x^(203 - j). The
decoder is the textbook bounded-distance one:

1. syndromes S_i = r(l^i), i = 0 .. 15; all zero: count 0, unchanged;
2. Berlekamp-Massey (Massey's update: the registers swap where the
   discrepancy is not 0 and 2 L <= r - 1) gives Lambda of degree nu;
   nu > 8: uncorrectable;
3. the Chien search over the 204 sent positions only (position p is
   the root l^(p + 52) of Lambda); as many distinct roots as nu, or
   uncorrectable;
4. Forney with the first root l^0: Omega = S Lambda mod x^16, the value
   at root l^i is X Omega(l^i) / Lambda'(l^i) with X = l^(-i); a zero
   value makes the codeword uncorrectable;
5. an uncorrectable codeword is returned as received with count -1;
   else the values are added at their positions and the count is nu.

The interleaver (EN 300 744 4.3.2, figure 6): byte n of the stream goes
to branch j = n mod 12; in the transmitter branch j is a FIFO of j * 17
bytes, in the receiver of (11 - j) * 17, each advancing one byte each
time its branch is used. A fresh FIFO holds zeros. Deinterleaved byte n
is then stream byte n - 2244 (11 packets). The receiver's state is its
FIFOs, 1122 bytes: branch 0's 187 first, then branch 1's 170, ...,
each oldest first.
"""

from __future__ import annotations

import functools

import torch

NN = 255
N, K = 204, 188
NROOTS = N - K          # 16
T = NROOTS // 2         # 8
PAD = NN - N            # 51
GFPOLY = 0x11D
BRANCHES, DEPTH = 12, 17
DELAY = (BRANCHES - 1) * BRANCHES * DEPTH          # 2244 bytes
CARRY = DEPTH * BRANCHES * (BRANCHES - 1) // 2     # 1122 bytes
#: codewords decoded at a time
_BLOCK = 4096


@functools.lru_cache(maxsize=None)
def _tables_cpu():
    alpha = [0] * 256            # alpha[i] = l^i (alpha[255] = alpha[0])
    log = [0] * 256              # log[0] is never read through a product
    sr = 1
    for i in range(NN):
        alpha[i] = sr
        log[sr] = i
        sr <<= 1
        if sr & 0x100:
            sr ^= GFPOLY
    alpha[NN] = 1
    return torch.tensor(alpha), torch.tensor(log)


@functools.lru_cache(maxsize=8)
def tables(device):
    alpha, log = _tables_cpu()
    return alpha.to(device), log.to(device)


class _Field:
    def __init__(self, device):
        self.alpha, self.log = tables(device)

    def mul(self, a, b):
        prod = self.alpha[(self.log[a] + self.log[b]) % NN]
        return torch.where((a == 0) | (b == 0), 0, prod)

    def pow(self, e):
        return self.alpha[e % NN]

    def inv(self, a):
        return self.alpha[(NN - self.log[a]) % NN]


def _xor(x: torch.Tensor, dim: int) -> torch.Tensor:
    out = torch.zeros_like(x.select(dim, 0))
    for b in range(8):
        out |= ((x >> b) & 1).sum(dim=dim).remainder(2) << b
    return out


# --------------------------------------------------------------------------
# RS(204,188)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _generator(device) -> torch.Tensor:
    """g(x) = prod_(i < 16) (x + l^i): int64[16] coefficients of x^15 ..
    x^0 (the leading 1 left out)."""
    f = _Field("cpu")
    g = torch.zeros(NROOTS + 1, dtype=torch.int64)
    g[0] = 1                                # g[k]: coefficient of x^k
    for i in range(NROOTS):
        root = f.pow(torch.tensor(i))
        g = torch.cat([torch.zeros(1, dtype=torch.int64), g[:-1]]) ^ \
            f.mul(g, root.expand_as(g))
    return g[:NROOTS].flip(0).to(device)


def rs_encode(msgs: torch.Tensor) -> torch.Tensor:
    """uint8[B, 188] messages -> uint8[B, 204] systematic codewords (the
    16 parity bytes after the message): the remainder of m(x) x^16 by
    g(x), by the division register."""
    f = _Field(msgs.device)
    taps = _generator(msgs.device)
    m = msgs.to(torch.int64)
    rem = torch.zeros((m.shape[0], NROOTS), dtype=torch.int64,
                      device=m.device)
    for j in range(K):
        fb = rem[:, 0] ^ m[:, j]
        rem = torch.cat([rem[:, 1:], torch.zeros_like(rem[:, :1])], dim=1)
        rem ^= f.mul(taps[None, :].expand_as(rem), fb[:, None].expand_as(rem))
    return torch.cat([m, rem], dim=1).to(torch.uint8)


def syndromes(cw: torch.Tensor) -> torch.Tensor:
    """int64[B, 204] -> int64[B, 16]: S_i = sum_j c_j l^(i (203 - j))."""
    f = _Field(cw.device)
    i = torch.arange(NROOTS, device=cw.device)[:, None]
    j = torch.arange(N, device=cw.device)[None, :]
    return _xor(f.mul(cw[:, None, :], f.pow(i * (N - 1 - j))[None]), dim=2)


def berlekamp_massey(s: torch.Tensor):
    """Syndromes int64[D, 16] -> (Lambda int64[D, 17], its degree)."""
    f = _Field(s.device)
    D, dev = s.shape[0], s.device
    lam = torch.zeros((D, NROOTS + 1), dtype=torch.int64, device=dev)
    lam[:, 0] = 1
    b = lam.clone()
    el = torch.zeros(D, dtype=torch.int64, device=dev)
    zero = torch.zeros((D, 1), dtype=torch.int64, device=dev)
    for r in range(1, NROOTS + 1):
        idx = torch.arange(r, device=dev)
        delta = _xor(f.mul(lam[:, :r], s[:, r - 1 - idx]), dim=1)
        xb = torch.cat([zero, b[:, :-1]], dim=1)
        nz = delta != 0
        swap = nz & (2 * el <= r - 1)
        b = torch.where(swap[:, None],
                        f.mul(lam, f.inv(delta)[:, None].expand_as(lam)),
                        xb)
        lam = torch.where(nz[:, None],
                          lam ^ f.mul(delta[:, None].expand_as(xb), xb), lam)
        el = torch.where(swap, r - el, el)
    k = torch.arange(NROOTS + 1, device=dev)
    return lam, torch.where(lam != 0, k, 0).amax(dim=1)


def _decode_dirty(cw: torch.Tensor, s: torch.Tensor):
    f = _Field(cw.device)
    D, dev = cw.shape[0], cw.device
    lam, nu = berlekamp_massey(s)
    # the sent positions p and their roots l^(p + 52)
    e = torch.arange(N, device=dev) + PAD + 1                  # [204]
    k = torch.arange(NROOTS + 1, device=dev)
    lam_at = _xor(f.mul(lam[:, :, None].expand(D, NROOTS + 1, N),
                        f.pow(k[:, None] * e[None, :])[None]
                        .expand(D, NROOTS + 1, N)), dim=1)     # [D, 204]
    is_root = lam_at == 0
    # Omega = S Lambda mod x^16
    ii = torch.arange(NROOTS, device=dev)
    pair = k[None, :] <= ii[:, None]                            # [16, 17]
    sidx = torch.where(pair, ii[:, None] - k[None, :], 0)
    omega = _xor(f.mul(s[:, sidx], lam[:, None, :].expand(D, NROOTS,
                                                          NROOTS + 1))
                 * pair, dim=2)                                 # [D, 16]
    num = _xor(f.mul(omega[:, :, None].expand(D, NROOTS, N),
                     f.pow(ii[:, None] * e[None, :])[None]
                     .expand(D, NROOTS, N)), dim=1)            # Omega(l^e)
    odd = torch.arange(1, NROOTS + 1, 2, device=dev)            # k odd
    den = _xor(f.mul(lam[:, odd][:, :, None].expand(D, odd.numel(), N),
                     f.pow((odd - 1)[:, None] * e[None, :])[None]
                     .expand(D, odd.numel(), N)), dim=1)       # Lambda'
    x = f.pow(NN - e)[None, :].expand(D, N)                     # l^(-e)
    value = f.mul(f.mul(x, num), f.inv(den))
    n_roots = is_root.sum(dim=1)
    ok = (nu <= T) & (n_roots == nu) & \
        ~(is_root & (value == 0)).any(dim=1)
    fixed = cw ^ torch.where(is_root, value, 0)
    count = torch.where(ok, nu, -1)
    return count, torch.where(ok[:, None], fixed, cw)


def rs_decode(cw: torch.Tensor):
    """[B, 204] received codewords (any integer type, byte values) ->
    (count int64[B]: corrected bytes, -1 where uncorrectable; data
    uint8[B, 188]: the corrected message, as received where -1)."""
    cw = cw.to(torch.int64)
    count = torch.zeros(cw.shape[0], dtype=torch.int64, device=cw.device)
    out = cw.clone()
    for a in range(0, cw.shape[0], _BLOCK):
        blk = cw[a:a + _BLOCK]
        s = syndromes(blk)
        rows = torch.nonzero((s != 0).any(dim=1)).flatten()
        if rows.numel():
            c, fixed = _decode_dirty(blk[rows], s[rows])
            count[a + rows] = c
            out[a + rows] = fixed
    return count, out[:, :K].to(torch.uint8)


# --------------------------------------------------------------------------
# The convolutional interleaver
# --------------------------------------------------------------------------


def interleave(stream: torch.Tensor) -> torch.Tensor:
    """The transmitter's interleaver from fresh (zero) FIFOs: uint8[S, L]
    (L a multiple of 12) -> uint8[S, L]."""
    S, L = stream.shape
    out = torch.empty_like(stream)
    for j in range(BRANCHES):
        x = stream[:, j::BRANCHES]
        fifo = torch.zeros((S, j * DEPTH), dtype=stream.dtype,
                           device=stream.device)
        out[:, j::BRANCHES] = torch.cat([fifo, x], dim=1)[:, :x.shape[1]]
    return out


def deinterleave(stream: torch.Tensor, carry: torch.Tensor | None = None):
    """The receiver's deinterleaver: uint8[S, L] (L a multiple of 12) and
    its FIFOs uint8[S, 1122] from the previous call (None: fresh, zeros)
    -> (uint8[S, L], the FIFOs after this call)."""
    S, L = stream.shape
    if carry is None:
        carry = torch.zeros((S, CARRY), dtype=stream.dtype,
                            device=stream.device)
    out = torch.empty_like(stream)
    fifos, at = [], 0
    for j in range(BRANCHES):
        depth = (BRANCHES - 1 - j) * DEPTH
        x = stream[:, j::BRANCHES]
        line = torch.cat([carry[:, at:at + depth], x], dim=1)
        out[:, j::BRANCHES] = line[:, :x.shape[1]]
        fifos.append(line[:, line.shape[1] - depth:])
        at += depth
    return out, torch.cat(fifos, dim=1)
