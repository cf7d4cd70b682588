"""Batched RS(120,110) decoder over GF(256), vectorized across codewords:
the port of ``viterbi_tpu.ops.rs``.

The reference's scalar DECODE_RS (rschecksf.cpp:198-377) loops over the
``RSDims`` interleaved codewords of a superframe; here the codewords are
the batch axis, and every data-dependent branch and early exit of
Berlekamp-Massey, Chien and Forney is masked full-length execution, so a
clean, a dirty and an uncorrectable batch cost the same. Results are
bit-identical to the scalar oracle (``golden.rs_decode_codeword``).

GF(256) arithmetic goes through the reference's log/antilog tables
(dllmain.cpp:124-150) as device tensors: products index the 256 x 256
product table built from them, inverses a 256-entry table
``alpha^(255 - log x)``, powers of alpha the antilog table itself. A
gather is one small launch on a GPU. The JAX package's gather-free form
(written for a machine where gathers are slow) is about forty times the
launches in eager PyTorch; ``probes.rsform`` keeps it as the tables'
cross-check and times both.

Syndromes and the Chien search are GF(2)-linear in the input bits, so
both are exact 0/1 matrix products (parity = count mod 2). The operands
are float32: 0/1 inputs and counts up to 960 are exact there (bf16
results would round them). There is no hand-written kernel here, as the
JAX module has none.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C

_ATO_NP, _IOF_NP = C.gf256_tables()


def _bit_matrices():
    """GF(2) bit-sliced evaluation matrices.

    s_i = XOR_j data[j] * alpha^(i*(119-j)) and q(i) = XOR_j lam[j] *
    alpha^(i*j) are linear over GF(2) in the bits of data and lam.
    Returns (SYND [960, 80], CHIEN [88, 2040]) uint8 0/1 matrices:
      SYND[(j,a), (i,b)]    = bit b of alpha^((a + i*(119-j)) % 255)
      CHIEN[(j,a), (i-1,b)] = bit b of alpha^((a + i*j) % 255), i=1..255
    """
    a = np.arange(8)
    j_s = np.arange(C.RS_N)
    e_s = (a[None, :, None] + np.arange(C.RS_NROOTS)[None, None, :]
           * (C.RS_N - 1 - j_s)[:, None, None]) % 255     # [120, 8, 10]
    v_s = _ATO_NP[e_s].astype(np.int64)
    synd = ((v_s[..., None] >> a) & 1).astype(np.uint8)    # [120,8,10,8]
    synd = synd.reshape(C.RS_N * 8, C.RS_NROOTS * 8)
    j_c = np.arange(C.RS_NROOTS + 1)
    e_c = (a[None, :, None] + np.arange(1, C.RS_NN + 1)[None, None, :]
           * j_c[:, None, None]) % 255                     # [11, 8, 255]
    v_c = _ATO_NP[e_c].astype(np.int64)
    chien = ((v_c[..., None] >> a) & 1).astype(np.uint8)   # [11,8,255,8]
    chien = chien.reshape((C.RS_NROOTS + 1) * 8, C.RS_NN * 8)
    return synd, chien


_SYND_M, _CHIEN_M = _bit_matrices()

def _inverse_table() -> np.ndarray:
    """inv[x] = alpha^(255 - log x), inv[0] = 0 (as the Fermat x^254)."""
    inv = _ATO_NP[255 - _IOF_NP.astype(np.int64)].astype(np.int64)
    inv[0] = 0
    return inv


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device) -> dict:
    """The constant tensors of the decoder on ``device``, made once."""
    nr = C.RS_NROOTS
    ii = np.arange(nr)[:, None]          # omega coefficient index i
    jj = np.arange(nr + 1)[None, :]      # lambda index j
    pair_ok = jj <= ii

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return {
        "ato": t(_ATO_NP), "mul": t(C.gf256_mul_table().reshape(-1)),
        "inv": t(_inverse_table()),
        "synd": t(_SYND_M, torch.float32), "chien": t(_CHIEN_M, torch.float32),
        "bit": t(np.arange(8)), "idx": t(np.arange(nr + 1)),
        "i_all": t(np.arange(1, C.RS_NN + 1)),
        "pair_ok": t(pair_ok, torch.bool), "s_idx": t(np.where(pair_ok,
                                                               ii - jj, 0)),
        "k": t(np.arange(nr)), "keven": t(np.arange(0, nr, 2)),
    }


def mod255(x: torch.Tensor) -> torch.Tensor:
    """Branch-free x % 255 for 0 <= x < 66299 with the reference's uint32
    wrap (rschecksf.cpp:48-52): the product in int64, masked to 32 bits
    before the shift."""
    return ((x.to(torch.int64) * 0x1010102) & 0xFFFFFFFF) >> 24


class _Table:
    """The field through the reference's tables on the data's device."""

    def __init__(self, tables: dict):
        self.t = tables

    def mul(self, a, b):
        return self.t["mul"][(a << 8) | b]

    def inv(self, x):
        return self.t["inv"][x]

    def pow_alpha(self, e):
        return self.t["ato"][e]

    def root_powers(self, root):
        return self.t["ato"][mod255(root[:, :, None] * self.t["k"])]


def _byte_bits(x: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """[..., n] bytes -> [..., n*8] float32 bits (LSB first)."""
    b = (x[..., None] >> bit) & 1
    return b.reshape(*x.shape[:-1], x.shape[-1] * 8).to(torch.float32)


def _gf2_matmul(bits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Exact parity product: [B, K] 0/1 @ [K, N] 0/1 -> [B, N] int64 0/1.
    float32 holds 0/1 and every count up to K <= 960 exactly."""
    return torch.matmul(bits, m).to(torch.int64) & 1


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (torch has no xor reduction): a fold by
    halves, four rounds for the eleven terms met here."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        lo = x[..., :h] ^ x[..., h:2 * h]
        x = lo if x.shape[-1] % 2 == 0 else \
            torch.cat([lo, x[..., 2 * h:]], dim=-1)
    return x[..., 0]


def rs_decode_blocks(blocks: torch.Tensor):
    """Decode a batch of shortened RS(120,110) codewords.

    ``blocks``: integer tensor [B, 120] of byte values, on any device.
    Returns ``(count, corrected)`` on that device:
      * count int32[B]: corrected byte errors per codeword, or -1
      * corrected int32[B, 120]: corrected codewords (unchanged where
        count is -1 or 0).
    Bit-exact against ``golden.rs_decode_codeword`` for every codeword.
    """
    return decode_with_field(blocks, _Table(_device_tables(blocks.device)))


def decode_with_field(blocks: torch.Tensor, gf):
    """``rs_decode_blocks`` over the field arithmetic ``gf`` (``mul``,
    ``inv``, ``pow_alpha``, ``root_powers`` on int64 tensors of byte
    values): the tables here, the bitwise form in ``probes.rsform``."""
    if blocks.dim() != 2 or blocks.shape[1] != C.RS_N:
        raise ValueError(f"blocks must be [B, {C.RS_N}], "
                         f"got {list(blocks.shape)}")
    T = _device_tables(blocks.device)
    data = blocks.to(torch.int64)
    B, NR = data.shape[0], C.RS_NROOTS

    # ---- syndromes (bit-matrix product) ----------------------------------
    sbits = _gf2_matmul(_byte_bits(data, T["bit"]), T["synd"])   # [B, 80]
    s = (sbits.reshape(B, NR, 8) << T["bit"]).sum(dim=-1)        # [B, 10]
    syn_zero = (s == 0).all(dim=1)
    s_rev = s.flip(1)

    # ---- Berlekamp-Massey: ten masked rounds, polynomial form ------------
    lam = torch.zeros((B, NR + 1), dtype=torch.int64, device=data.device)
    lam[:, 0] = 1
    b = lam.clone()
    el = torch.zeros(B, dtype=torch.int64, device=data.device)
    zcol = torch.zeros((B, 1), dtype=torch.int64, device=data.device)
    for r in range(1, NR + 1):
        # discrepancy: XOR over i < r of lam[i] * s[r-1-i]
        discr = _xor_reduce(gf.mul(lam[:, :r], s_rev[:, NR - r:]))
        shift_b = torch.cat([zcol, b[:, :-1]], dim=1)            # x * b(x)
        upd = (2 * el <= r - 1) & (discr != 0)                   # swap
        # b(x) <- lambda(x) / discr where the registers swap
        b = torch.where(upd[:, None],
                        gf.mul(lam, gf.inv(discr)[:, None]), shift_b)
        # lambda(x) - discr * x * b(x): unchanged where discr == 0
        lam = lam ^ gf.mul(discr[:, None], shift_b)
        el = torch.where(upd, r - el, el)

    deg_lambda = torch.where(lam != 0, T["idx"], 0).amax(dim=1)

    # ---- Chien search over all 255 field elements (bit-matrix product) ---
    # q(i) = XOR_j lam[j] * alpha^(i*j). Counting all roots equals the
    # reference's search that stops at deg_lambda roots: a polynomial of
    # degree d has at most d.
    qbits = _gf2_matmul(_byte_bits(lam, T["bit"]), T["chien"])   # [B, 2040]
    is_root = qbits.reshape(B, C.RS_NN, 8).sum(dim=-1) == 0
    count = is_root.sum(dim=1)
    correctable = count == deg_lambda
    # the ten smallest root indices in ascending order; 999 fills the rest
    root_keys = torch.where(is_root, T["i_all"], 999)
    roots = torch.topk(root_keys, NR, dim=1, largest=False,
                       sorted=True).values                       # [B, 10]
    root_ok = roots < 999

    # ---- omega = s(x) * lambda(x) mod x^10 --------------------------------
    oterm = gf.mul(s[:, T["s_idx"]], lam[:, None, :])            # [B,10,11]
    omega = _xor_reduce(torch.where(T["pair_ok"], oterm, 0))     # [B, 10]

    # ---- Forney error values at each root ---------------------------------
    safe_root = torch.where(root_ok, roots, 0)
    pw = gf.root_powers(safe_root)                 # alpha^(k*root) [B,10,10]
    deg_omega = deg_lambda - 1
    n1_valid = T["k"] <= deg_omega[:, None, None]
    num1 = _xor_reduce(torch.where(n1_valid,
                                   gf.mul(omega[:, None, :], pw), 0))
    num2 = gf.pow_alpha(C.RS_NN - safe_root)
    top = deg_lambda.clamp(max=NR - 1) & ~1
    d_valid = T["keven"] <= top[:, None, None]
    d_term = gf.mul(lam[:, None, T["keven"] + 1], pw[:, :, T["keven"]])
    den = _xor_reduce(torch.where(d_valid, d_term, 0))           # [B, 10]
    # num1 * num2 / den; den != 0 wherever applied (simple roots)
    errval = gf.mul(gf.mul(num1, num2), gf.inv(den))

    pos = roots - 1 - C.RS_PAD
    apply = root_ok & (roots >= C.RS_PAD + 1) & (num1 != 0) & \
        (correctable & ~syn_zero)[:, None]
    # applied roots are distinct, so the sum places each value alone
    corr = torch.zeros_like(data).scatter_add_(
        1, pos.clamp(0, C.RS_N - 1), torch.where(apply, errval, 0))

    count = torch.where(syn_zero, 0, torch.where(correctable, count, -1))
    corrected = torch.where(count[:, None] >= 0, data ^ corr, data)
    return count.to(torch.int32), corrected.to(torch.int32)


def deinterleave(p: torch.Tensor, rs_dims: int) -> torch.Tensor:
    """[rs_dims*120] byte-interleaved superframe -> [rs_dims, 120] blocks."""
    return p.reshape(C.RS_N, rs_dims).T


def interleave_data(blocks: torch.Tensor, rs_dims: int) -> torch.Tensor:
    """[rs_dims, 110] corrected data -> [rs_dims*110] interleaved output."""
    return blocks.T.reshape(rs_dims * C.RS_KK)


def rs_check_superframe(p: torch.Tensor, rs_dims: int):
    """Batched twin of RScheckSuperframe (rschecksf.cpp:64-93).

    ``p``: integer tensor [rs_dims * 120]. Returns (errors, out, n_ok) on
    its device:
      * errors int32 scalar: total corrected bytes, or -1 if any codeword
        is uncorrectable (the reference aborts at the first such one)
      * out uint8[rs_dims * 110]: corrected data. On -1 the reference has
        scattered every corrected codeword before the failed one into the
        caller's buffer (rschecksf.cpp:74-88); here codewords from the
        first failure onward are zero-filled, and
      * n_ok int32 scalar says how many leading codewords are valid
        (rs_dims when errors != -1).
    """
    count, corrected = rs_decode_blocks(deinterleave(p, rs_dims))
    failed = count < 0
    any_failed = failed.any()
    first_fail = failed.to(torch.int32).argmax()   # gated by any_failed
    errors = torch.where(any_failed, -1, count.sum())
    n_ok = torch.where(any_failed, first_fail, rs_dims)
    cw_idx = torch.arange(rs_dims, device=p.device)
    out_blocks = torch.where((cw_idx < n_ok)[:, None],
                             corrected[:, :C.RS_KK], 0)
    out = interleave_data(out_blocks, rs_dims).to(torch.uint8)
    return errors.to(torch.int32), out, n_ok.to(torch.int32)
