"""Plain reference RS(120,110) decoder and DAB+ superframe check, in plain
torch on any device, vectorised over codewords.

Written from the reference's description (viterbi.h:94-105,
rschecksf.cpp:45-377, dllmain.cpp:124-150), not from the program under
test, and importing nothing of it. GF(256) with field polynomial 0x11D,
ten roots from alpha^0 (FCR 0), shortened by 135 bytes. Per codeword,
as the reference's DECODE_RS:

* syndromes s_i = sum_j c_j alpha^(i (119 - j)); all zero: 0, unchanged;
* Berlekamp-Massey over the ten syndromes (the reference's update order:
  the register swaps where 2 L <= r - 1 and the discrepancy is not 0);
* the Chien search over alpha^1 ... alpha^255; as many roots as the
  locator's degree, or the codeword is uncorrectable (-1, unchanged);
* the count returned is the number of roots, those inside the shortening
  pad (root <= 135) included, though they change no byte;
* Forney at each root past the pad, skipped where the evaluator's value
  is 0: the byte at root - 136 is XORed with
  alpha^(log num1 + log alpha^(255 - root) + 255 - log den), den the odd
  part of the locator at the root (log 0 taken as 255, as the table has
  it).

``check_superframes`` is RScheckSuperframe over rows of superframes
(byte k of codeword j at j + k * rs_dims): the error sum or -1, the
corrected data interleaved (a failed codeword as received), and the
number of codewords before the first failure.
"""

from __future__ import annotations

import functools

import torch

NN = 255
NROOTS = 10
PAD = 135
N = NN - PAD          # 120
KK = N - NROOTS       # 110
GFPOLY = 0x11D


@functools.lru_cache(maxsize=None)
def _tables_cpu():
    alpha = [0] * 256           # alpha_to[i] = alpha^i, alpha_to[255] = 0
    log = [0] * 256             # index_of[x]; index_of[0] = 255
    log[0] = NN
    sr = 1
    for i in range(NN):
        log[sr] = i
        alpha[i] = sr
        sr <<= 1
        if sr & 0x100:
            sr ^= GFPOLY
    return torch.tensor(alpha), torch.tensor(log)


@functools.lru_cache(maxsize=8)
def tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha_to int64[256], index_of int64[256]) on ``device``."""
    alpha, log = _tables_cpu()
    return alpha.to(device), log.to(device)


class _Field:
    def __init__(self, device):
        self.alpha, self.log = tables(device)

    def mul(self, a, b):
        """Elementwise product of byte tensors (int64)."""
        prod = self.alpha[(self.log[a] + self.log[b]) % NN]
        return torch.where((a == 0) | (b == 0), 0, prod)

    def pow(self, e):
        return self.alpha[e % NN]


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of byte values along ``dim``, bit by bit through sums."""
    out = torch.zeros_like(x.select(dim, 0))
    for b in range(8):
        out |= ((x >> b) & 1).sum(dim=dim).remainder(2) << b
    return out


def syndromes(cw: torch.Tensor) -> torch.Tensor:
    """int64[B, 120] codewords -> int64[B, 10] syndromes."""
    f = _Field(cw.device)
    i = torch.arange(NROOTS, device=cw.device)[:, None]
    j = torch.arange(N, device=cw.device)[None, :]
    powers = f.pow(i * (N - 1 - j))                        # [10, 120]
    return xor_reduce(f.mul(cw[:, None, :], powers[None]), dim=2)


def locate(s: torch.Tensor):
    """Berlekamp-Massey and the Chien search on syndromes int64[D, 10]:
    (lambda int64[D, 11], its degree int64[D], is_root bool[D, 255] with
    alpha^(i+1) at column i)."""
    f = _Field(s.device)
    D, dev = s.shape[0], s.device
    lam = torch.zeros((D, NROOTS + 1), dtype=torch.int64, device=dev)
    lam[:, 0] = 1
    b = lam.clone()
    el = torch.zeros(D, dtype=torch.int64, device=dev)
    zero = torch.zeros((D, 1), dtype=torch.int64, device=dev)
    for r in range(1, NROOTS + 1):
        # discrepancy: sum over i < r of lambda_i s_(r-1-i)
        idx = torch.arange(r, device=dev)
        discr = xor_reduce(f.mul(lam[:, :r], s[:, r - 1 - idx]), dim=1)
        xb = torch.cat([zero, b[:, :-1]], dim=1)
        nz = discr != 0
        swap = nz & (2 * el <= r - 1)
        inv = f.pow(NN - f.log[discr])                     # 1 / discr
        b = torch.where(swap[:, None], f.mul(lam, inv[:, None]), xb)
        lam = torch.where(nz[:, None], lam ^ f.mul(discr[:, None], xb), lam)
        el = torch.where(swap, r - el, el)
    k = torch.arange(NROOTS + 1, device=dev)
    deg = torch.where(lam != 0, k, 0).amax(dim=1)

    # Chien: lambda(alpha^i), i = 1..255
    i = torch.arange(1, NN + 1, device=dev)
    q = xor_reduce(f.mul(lam[:, :, None], f.pow(k[:, None] * i)[None]),
                   dim=1)                                  # [D, 255]
    return lam, deg, q == 0


def _decode_dirty(cw: torch.Tensor, s: torch.Tensor):
    """Decode codewords whose syndromes are not all zero: (count int64[D],
    corrected int64[D, 120])."""
    f = _Field(cw.device)
    D, dev = cw.shape[0], cw.device
    lam, deg, is_root = locate(s)
    i = torch.arange(1, NN + 1, device=dev)
    n_roots = is_root.sum(dim=1)
    ok = n_roots == deg

    # omega_i = sum_(j <= i) s_(i-j) lambda_j, i < deg
    ii = torch.arange(NROOTS, device=dev)
    jj = torch.arange(NROOTS + 1, device=dev)
    pair = (jj[None, :] <= ii[:, None])                     # [10, 11]
    sidx = torch.where(pair, ii[:, None] - jj[None, :], 0)
    terms = f.mul(s[:, sidx], lam[:, None, :]) * pair      # [D, 10, 11]
    omega = xor_reduce(terms, dim=2)                       # [D, 10]
    omega = torch.where(ii[None, :] < deg[:, None], omega, 0)

    # Forney at every field element; applied at the roots past the pad
    num1 = xor_reduce(f.mul(omega[:, :, None],
                            f.pow(ii[:, None] * i)[None]), dim=1)
    top = torch.clamp(deg, max=NROOTS - 1) & ~1             # [D]
    even = torch.arange(0, NROOTS, 2, device=dev)           # i = 0, 2, .., 8
    lam_odd = lam[:, even + 1]                              # lambda_(i+1)
    use = even[None, :] <= top[:, None]                     # [D, 5]
    den = xor_reduce(f.mul((lam_odd * use)[:, :, None],
                           f.pow(even[:, None] * i)[None]), dim=1)
    num2_log = (NN - i) % NN                                # log alpha^(255-i)
    value = f.alpha[(f.log[num1] + num2_log + NN - f.log[den]) % NN]
    fix = is_root & (i > PAD)[None, :] & (num1 != 0) & ok[:, None]
    pos = i - 1 - PAD                                       # [255]
    err = torch.zeros((D, N), dtype=torch.int64, device=dev)
    cols = torch.clamp(pos, min=0).expand(D, -1)
    err.scatter_add_(1, cols, torch.where(fix, value, 0))
    # every root lands on its own byte, so the sum above is the XOR
    corrected = cw ^ err
    count = torch.where(ok, n_roots, -1)
    corrected = torch.where(ok[:, None], corrected, cw)
    return count, corrected


#: codewords a block of the vectorised decode
_BLOCK = 8192


def decode_codewords(cw: torch.Tensor):
    """Decode [B, 120] codewords (any integer type): (count int64[B], -1
    where uncorrectable; corrected int64[B, 120], unchanged where count is
    0 or -1)."""
    cw = cw.to(torch.int64)
    s = torch.cat([syndromes(cw[i:i + _BLOCK])
                   for i in range(0, cw.shape[0], _BLOCK)]) \
        if cw.shape[0] else torch.zeros((0, NROOTS), dtype=torch.int64,
                                        device=cw.device)
    dirty = (s != 0).any(dim=1)
    count = torch.zeros(cw.shape[0], dtype=torch.int64, device=cw.device)
    corrected = cw.clone()
    idx = torch.nonzero(dirty).flatten()
    for i in range(0, idx.numel(), _BLOCK):
        rows = idx[i:i + _BLOCK]
        c, fixed = _decode_dirty(cw[rows], s[rows])
        count[rows] = c
        corrected[rows] = fixed
    return count, corrected


def check_superframes(sf: torch.Tensor, rs_dims: int):
    """RScheckSuperframe over uint8[G, rs_dims*120] interleaved superframes:
    (errors int64[G]: the sum of counts or -1; audio uint8[G,
    rs_dims*110]: every codeword's data as decoded, interleaved; n_ok
    int64[G]: codewords before the first failure)."""
    G = sf.shape[0]
    cw = sf.reshape(G, N, rs_dims).transpose(1, 2).reshape(G * rs_dims, N)
    count, corrected = decode_codewords(cw)
    count = count.reshape(G, rs_dims)
    failed = count < 0
    any_failed = failed.any(dim=1)
    n_ok = torch.where(any_failed, failed.to(torch.int64).argmax(dim=1),
                       rs_dims)
    errors = torch.where(any_failed, -1, count.sum(dim=1))
    audio = corrected.reshape(G, rs_dims, N)[:, :, :KK].transpose(1, 2) \
        .reshape(G, rs_dims * KK).to(torch.uint8)
    return errors, audio, n_ok


def export_buffer(audio: torch.Tensor, errors: int, n_ok: int,
                  rs_dims: int, before: torch.Tensor) -> torch.Tensor:
    """What RScheckSuperframe leaves in the caller's buffer ``before``
    (uint8[rs_dims*110]): every byte of ``audio`` on success; on -1 only
    the codewords before the first failure, each byte at its interleaved
    place, the rest as it was."""
    if errors != -1:
        return audio.clone()
    out = before.clone()
    j = torch.arange(rs_dims * KK, device=audio.device) % rs_dims
    keep = j < n_ok
    out[keep] = audio[keep]
    return out
