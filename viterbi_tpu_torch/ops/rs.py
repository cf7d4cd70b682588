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
results would round them).

That masked form is the plain version, ``rs_decode_blocks_plain``: about
340 small launches a call on a card, whatever the batch. On a card kernel
I (``csrc/rs_decode.cu``) runs instead, once a call, as the JAX package
runs each of its two entries as one jitted program:

* ``rs_check_superframes`` (the DAB+ chain's RS stage, the export):
  uint8 superframes as they arrive in, the corrected audio interleaved,
  each superframe's error sum and first failed codeword out;
* ``rs_decode_blocks``: uint8 or int32 codewords laid out with any
  strides in, counts and int32 codewords out.

Their plain versions, ``rs_check_superframes_plain`` and
``rs_decode_blocks_plain``, serve the CPU and the comparisons.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from . import _build

_ATO_NP, _IOF_NP = C.gf256_tables()
#: kernel I's field: the 768-entry antilog table, then index_of
_KERNEL_TABLES_NP = np.concatenate([_ATO_NP, _IOF_NP]).astype(np.uint8)


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


def _synd_fragments(synd: np.ndarray = _SYND_M,
                    nroots: int = C.RS_NROOTS) -> np.ndarray:
    """A syndrome matrix (``_SYND_M``, or ``_SYND204_M``) as kernel I's
    tensor cores read it: the B operand of
    ``mma.m16n8k256.row.col...b1.and.popc``, ``uint32[nroots, steps, 32,
    2]``.

    The codeword's bits (bit a of byte j at k = 8 j + a; 960 for
    RS(120,110)) are padded to whole k-steps of 256 (four; seven for
    RS(204,188)); n-tile i holds syndrome i's eight bits (columns 8 i ..
    8 i + 7). Lane l (group g = l // 4, tig = l % 4) holds column g and,
    in word r, k = 256 step + 128 r + 32 tig + bit."""
    steps = -(-synd.shape[0] // 256)
    m = np.zeros((256 * steps, nroots * 8), np.uint64)
    m[:synd.shape[0]] = synd
    lane = np.arange(32)
    bit = np.arange(32, dtype=np.uint64)
    frag = np.zeros((nroots, steps, 32, 2), np.uint64)
    for i in range(nroots):
        for step in range(steps):
            for r in range(2):
                k = (256 * step + 128 * r + 32 * (lane & 3))[:, None] \
                    + np.arange(32)[None, :]                  # [lane, bit]
                col = (8 * i + (lane >> 2))[:, None]
                frag[i, step, :, r] = (m[k, col] << bit).sum(axis=1)
    return frag.astype(np.uint32)


_SYND_FRAGMENTS_NP = _synd_fragments()

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


def _check_blocks(blocks: torch.Tensor) -> None:
    if blocks.dim() not in (2, 3) or blocks.shape[-1] != C.RS_N:
        raise ValueError(f"blocks must be [B, {C.RS_N}] or [G, D, "
                         f"{C.RS_N}], got {list(blocks.shape)}")


def rs_decode_blocks_plain(blocks: torch.Tensor):
    """``rs_decode_blocks`` in plain torch through the reference's tables
    (``decode_with_field``), on any device: kernel I's plain version."""
    _check_blocks(blocks)
    lead = blocks.shape[:-1]
    count, corrected = decode_with_field(
        blocks.reshape(-1, C.RS_N), _Table(_device_tables(blocks.device)))
    return count.reshape(lead), corrected.reshape(*lead, C.RS_N)


@functools.lru_cache(maxsize=8)
def _kernel_consts(device: torch.device) -> tuple:
    """Kernel I's constants on ``device``: the tables, B's fragments."""
    return (torch.from_numpy(_KERNEL_TABLES_NP).to(device),
            torch.from_numpy(_SYND_FRAGMENTS_NP.view(np.int32)).to(device))


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _card_only(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def rs_decode_blocks(blocks: torch.Tensor):
    """Decode a batch of shortened RS(120,110) codewords.

    ``blocks``: integer tensor [B, 120] of byte values, or [G, D, 120]
    (D codewords a superframe, as the chain hands them), any strides.
    Returns ``(count, corrected)`` on its device, shaped by the leading
    dimensions:
      * count int32[B]: corrected byte errors per codeword, or -1
      * corrected int32[B, 120]: corrected codewords (unchanged where
        count is -1 or 0).
    Bit-exact against ``golden.rs_decode_codeword`` for every codeword.

    On a CUDA tensor (uint8 or int32, read in place through its strides)
    this launches kernel I; on a CPU tensor it is
    ``rs_decode_blocks_plain``.
    """
    if blocks.device.type == "cpu":
        return rs_decode_blocks_plain(blocks)
    return launch_codewords(_build.RS_DECODE, blocks, "rs_decode_blocks")


def launch_codewords(kernel: _build.Kernel, blocks: torch.Tensor,
                     name: str):
    """``rs_decode_blocks``' launch of ``kernel`` (kernel I, or a probe's
    build of its device code) on a CUDA tensor."""
    _card_only(blocks, name)
    _check_blocks(blocks)
    elem = {torch.uint8: 1, torch.int32: 4}.get(blocks.dtype)
    if elem is None:
        raise TypeError(f"{name}: kernel I reads uint8 or int32 codewords, "
                        f"got {blocks.dtype}")
    lead = blocks.shape[:-1]
    view = blocks if blocks.dim() == 3 else blocks.unsqueeze(1)
    G, D = view.shape[0], view.shape[1]
    count = torch.empty(lead, dtype=torch.int32, device=blocks.device)
    corrected = torch.empty((*lead, C.RS_N), dtype=torch.int32,
                            device=blocks.device)
    if G * D == 0:
        return count, corrected
    tables, frags = _kernel_consts(blocks.device)
    kernel.launch(
        blocks.device, view.data_ptr(), elem, G * D, D, view.stride(0),
        view.stride(1), view.stride(2), tables.data_ptr(), frags.data_ptr(),
        count.data_ptr(), corrected.data_ptr(), _sms(blocks.device.index))
    return count, corrected


def _check_superframes(sf: torch.Tensor, rs_dims: int) -> None:
    if rs_dims < 1 or sf.dim() != 2 or sf.shape[1] != rs_dims * C.RS_N:
        raise ValueError(f"superframes must be [G, rs_dims*{C.RS_N}] with "
                         f"rs_dims >= 1, got {list(sf.shape)} and rs_dims "
                         f"{rs_dims}")


def rs_check_superframes_plain(sf: torch.Tensor, rs_dims: int, *,
                               zero_after_fail: bool):
    """``rs_check_superframes`` in plain torch on any device:
    ``rs_decode_blocks_plain`` on each superframe's deinterleaved
    codewords, then the sums, the first failure and the interleave."""
    _check_superframes(sf, rs_dims)
    G = sf.shape[0]
    count, corrected = rs_decode_blocks_plain(
        sf.reshape(G, C.RS_N, rs_dims).transpose(1, 2).reshape(-1, C.RS_N))
    count = count.reshape(G, rs_dims)
    corrected = corrected.reshape(G, rs_dims, C.RS_N)
    failed = count < 0
    any_failed = failed.any(dim=1)
    first_fail = failed.to(torch.int32).argmax(dim=1)  # gated by any_failed
    errors = torch.where(any_failed, -1, count.sum(dim=1)).to(torch.int32)
    n_ok = torch.where(any_failed, first_fail, rs_dims).to(torch.int32)
    data = corrected[:, :, :C.RS_KK]
    if zero_after_fail:
        cw_idx = torch.arange(rs_dims, device=sf.device)
        data = torch.where((cw_idx[None, :] < n_ok[:, None])[..., None],
                           data, 0)
    out = data.transpose(1, 2).reshape(G, rs_dims * C.RS_KK) \
        .to(torch.uint8)
    return errors, out, n_ok


def rs_check_superframes(sf: torch.Tensor, rs_dims: int, *,
                         zero_after_fail: bool, out: tuple | None = None):
    """Check and correct a batch of DAB+ superframes: RScheckSuperframe
    (rschecksf.cpp:64-93) over the rows of ``sf``.

    ``sf``: uint8 [G, rs_dims*120], each row a byte-interleaved
    superframe (codeword n's byte j at j * rs_dims + n). Returns on its
    device:
      * errors int32[G]: corrected bytes, or -1 if any codeword is
        uncorrectable;
      * out uint8[G, rs_dims*110]: the corrected data bytes, interleaved;
        with ``zero_after_fail`` zero from the first failed codeword on
        (the export's form), else every codeword as decoded (the chain's);
      * n_ok int32[G]: the first failed codeword, else rs_dims.

    ``out``: (errors, data, n_ok) tensors of those shapes and types on
    ``sf``'s device to write into and return (``superframe_buffer``).

    On a CUDA tensor this launches kernel I once (rows any distance
    apart, bytes contiguous); on a CPU tensor (any integer type) it is
    ``rs_check_superframes_plain``.
    """
    if sf.device.type == "cpu":
        got = rs_check_superframes_plain(sf, rs_dims,
                                         zero_after_fail=zero_after_fail)
        if out is None:
            return got
        for o, g in zip(out, got, strict=True):
            o.copy_(g)
        return out
    return launch_superframes(_build.RS_SUPERFRAMES, sf, rs_dims,
                              zero_after_fail, out, "rs_check_superframes")


_RESULT_TYPES = (torch.int32, torch.uint8, torch.int32)


def launch_superframes(kernel: _build.Kernel, sf: torch.Tensor,
                       rs_dims: int, zero_after_fail: bool,
                       out: tuple | None, name: str):
    """``rs_check_superframes``' launch of ``kernel`` (kernel I, or a
    probe's build of its device code) on a CUDA tensor."""
    _card_only(sf, name)
    _check_superframes(sf, rs_dims)
    if sf.dtype != torch.uint8:
        raise TypeError(f"{name}: kernel I reads uint8 superframes, got "
                        f"{sf.dtype}")
    if sf.shape[1] and sf.stride(1) != 1:
        raise ValueError(f"{name}: a superframe's bytes must be "
                         f"contiguous")
    G, dev = sf.shape[0], sf.device
    if out is None:
        out = _result_buffer(G, rs_dims, dev)[1]
    else:
        shapes = ((G,), (G, rs_dims * C.RS_KK), (G,))
        for o, shape, dtype in zip(out, shapes, _RESULT_TYPES, strict=True):
            if (tuple(o.shape) != shape or o.dtype != dtype
                    or o.device != dev or not o.is_contiguous()):
                raise ValueError(f"{name}: out must be contiguous {dtype} "
                                 f"{list(shape)} on {dev}")
    errors, data, n_ok = out
    if G == 0:
        return out
    tables, frags = _kernel_consts(dev)
    # a single row's stride is any number: its own length aligns best
    s_g = sf.stride(0) if G > 1 else sf.shape[1]
    kernel.launch(
        dev, sf.data_ptr(), s_g, G, rs_dims, int(zero_after_fail),
        tables.data_ptr(), frags.data_ptr(), errors.data_ptr(),
        data.data_ptr(), n_ok.data_ptr(), _sms(dev.index))
    return out


def _result_buffer(G: int, rs_dims: int, device) -> tuple:
    """One uint8 allocation for G superframes' results: the corrected
    bytes at 0, then errors and n_ok as int32 from a 16-byte boundary.
    Returns (buffer, (errors [G], data [G, rs_dims*110], n_ok [G]))."""
    n = G * rs_dims * C.RS_KK
    tail = -(-n // 16) * 16
    buf = torch.empty(tail + 8 * G, dtype=torch.uint8, device=device)
    return buf, (buf[tail:tail + 4 * G].view(torch.int32),
                 buf[:n].view(G, rs_dims * C.RS_KK),
                 buf[tail + 4 * G:].view(torch.int32))


def superframe_buffer(rs_dims: int, device) -> tuple:
    """One superframe's three results in one uint8 buffer, so that one
    copy brings them back. Returns (buffer, (errors [1], data [1,
    rs_dims*110], n_ok [1]) views for ``rs_check_superframes``'s ``out``);
    ``unpack_superframe_buffer`` reads a host copy."""
    return _result_buffer(1, rs_dims, device)


def unpack_superframe_buffer(host: np.ndarray, rs_dims: int) -> tuple:
    """(errors int, data uint8[rs_dims*110], n_ok int) of a host copy of
    ``superframe_buffer``'s buffer."""
    n = rs_dims * C.RS_KK
    tail = -(-n // 16) * 16
    errors, n_ok = (int(v) for v in host[tail:tail + 8].view(np.int32))
    return errors, host[:n], n_ok


def _locate(data: torch.Tensor, gf, T: dict):
    """Syndromes, Berlekamp-Massey and the Chien search of int64 codewords
    [B, 120]: (s [B, 10], syn_zero [B], lambda [B, 11], deg_lambda [B],
    is_root [B, 255], field element i + 1 at column i)."""
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
    return s, syn_zero, lam, deg_lambda, is_root


def decoder_work(blocks: torch.Tensor) -> dict:
    """What the reference's scalar decoder (``golden.rs_decode_codeword``)
    needs beyond the syndromes for each codeword of ``blocks`` [B, 120],
    as kernel I's bound counts it: ``dirty`` (syndromes not all zero),
    ``deg_lambda``, ``terms`` (lambda's nonzero coefficients past the
    first, the terms its Chien search evaluates at an element), ``chien``
    (the field elements that search visits, up to its deg_lambda-th root,
    or all 255 where it finds fewer),
    ``correctable`` (dirty, and as many roots as deg_lambda) and
    ``forney`` (the roots past the shortening pad that Forney evaluates,
    where correctable). Plain torch on the blocks' device."""
    _check_blocks(blocks)
    data = blocks.reshape(-1, C.RS_N).to(torch.int64)
    T = _device_tables(blocks.device)
    _, syn_zero, lam, deg_lambda, is_root = _locate(data, _Table(T), T)
    n_roots = is_root.sum(dim=1)
    last = torch.where(is_root, T["i_all"], 0).amax(dim=1)
    dirty = ~syn_zero
    correctable = dirty & (n_roots == deg_lambda)
    past_pad = (is_root & (T["i_all"] >= C.RS_PAD + 1)).sum(dim=1)
    return {"dirty": dirty, "deg_lambda": deg_lambda,
            "terms": (lam[:, 1:] != 0).sum(dim=1),
            "chien": torch.where(n_roots == deg_lambda, last, C.RS_NN),
            "correctable": correctable,
            "forney": torch.where(correctable, past_pad, 0)}


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
    s, syn_zero, lam, deg_lambda, is_root = _locate(data, gf, T)
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

    ``p``: [rs_dims * 120] bytes (uint8; on the CPU any integer type).
    Returns (errors, out, n_ok) on its device:
      * errors int32 scalar: total corrected bytes, or -1 if any codeword
        is uncorrectable (the reference aborts at the first such one)
      * out uint8[rs_dims * 110]: corrected data. On -1 the reference has
        scattered every corrected codeword before the failed one into the
        caller's buffer (rschecksf.cpp:74-88); here codewords from the
        first failure onward are zero-filled, and
      * n_ok int32 scalar says how many leading codewords are valid
        (rs_dims when errors != -1).
    ``rs_check_superframes`` of one superframe into one buffer
    (``superframe_buffer``): kernel I once on a card.
    """
    _, views = superframe_buffer(rs_dims, p.device)
    errors, out, n_ok = rs_check_superframes(p.reshape(1, -1), rs_dims,
                                             zero_after_fail=True, out=views)
    return errors[0], out[0], n_ok[0]


# --------------------------------------------------------------------------
# RS(204,188): the outer code of an MPEG-2 transport stream in DAB stream
# mode (ETSI TS 102 427, EN 300 744 clause 4.3.2)
# --------------------------------------------------------------------------

#: RS(204,188, t = 8): the field and first root of RS(120,110), sixteen
#: roots, shortened from RS(255,239) by 51 leading zero bytes
P_N, P_K, P_NROOTS = 204, 188, 16
P_PAD = C.RS_NN - P_N
P_T = P_NROOTS // 2


def _packet_matrices():
    """GF(2) matrices of RS(204,188), as ``_bit_matrices``: (SYND
    [1632, 128]: bit b of syndrome i from bit a of byte j; ROOTS [136,
    1632]: bit b of lambda(alpha^(p + 52)) at sent position p from bit a
    of lambda's coefficient k; OMEGA [128, 1632]: omega(alpha^(p + 52))
    from omega's 16 coefficients; DERIV [64, 1632]: lambda'(alpha^(p +
    52)) from lambda's odd coefficients 1, 3, .., 15)."""
    a = np.arange(8)

    def bits(e):                      # [..., 8 a, ...] exponents -> bits b
        v = _ATO_NP[e % 255].astype(np.int64)
        return (v[..., None] >> a) & 1

    j = np.arange(P_N)
    i = np.arange(P_NROOTS)
    synd = bits(a[None, :, None] + i[None, None, :] * (P_N - 1 - j)[:, None,
                                                                    None])
    synd = synd.reshape(P_N * 8, P_NROOTS * 8)
    e = np.arange(P_N) + P_PAD + 1                       # the sent roots

    def at_roots(powers):             # powers [n] of x -> [n * 8, 204 * 8]
        m = bits(a[None, :, None] + powers[:, None, None] * e[None, None, :])
        return m.reshape(len(powers) * 8, P_N * 8)
    return (synd.astype(np.uint8),
            at_roots(np.arange(P_NROOTS + 1)).astype(np.uint8),
            at_roots(np.arange(P_NROOTS)).astype(np.uint8),
            at_roots(np.arange(0, P_NROOTS, 2)).astype(np.uint8))


_SYND204_M, _ROOTS204_M, _OMEGA204_M, _DERIV204_M = _packet_matrices()
_SYND204_FRAGMENTS_NP = _synd_fragments(_SYND204_M, P_NROOTS)


@functools.lru_cache(maxsize=8)
def _packet_tables(device: torch.device) -> dict:
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)
    return {"synd": t(_SYND204_M), "roots": t(_ROOTS204_M),
            "omega": t(_OMEGA204_M), "deriv": t(_DERIV204_M),
            "bit": t(np.arange(8), torch.int64),
            "idx": t(np.arange(P_NROOTS + 1), torch.int64),
            "x": t(_ATO_NP[(255 - (np.arange(P_N) + P_PAD + 1)) % 255],
                   torch.int64)}


def _gf2_bytes(bits: torch.Tensor, m: torch.Tensor, n: int) -> torch.Tensor:
    """Bytes [B, n] of the parity product of 0/1 ``bits`` [B, K] with
    ``m`` [K, 8 n] (float32 holds every count up to K <= 1632)."""
    prod = _gf2_matmul(bits, m).reshape(bits.shape[0], n, 8)
    return (prod << torch.arange(8, device=bits.device)).sum(dim=-1)


def _check_packets(cw: torch.Tensor) -> None:
    if cw.dim() != 2 or cw.shape[1] != P_N:
        raise ValueError(f"codewords must be [B, {P_N}], got "
                         f"{list(cw.shape)}")


def rs_decode_packets_plain(cw: torch.Tensor):
    """``rs_decode_packets`` in plain torch on any device: the syndromes,
    the locator at the sent positions, omega and lambda' there as GF(2)
    products; Berlekamp-Massey in sixteen masked rounds through the
    reference's tables; every step for every codeword. Kernel I's
    packets entry's plain version."""
    _check_packets(cw)
    B, dev = cw.shape[0], cw.device
    gf = _Table(_device_tables(dev))
    T = _packet_tables(dev)
    data = cw.to(torch.int64) & 0xFF
    s = _gf2_bytes(_byte_bits(data, T["bit"]), T["synd"], P_NROOTS)
    dirty = (s != 0).any(dim=1)

    lam = torch.zeros((B, P_NROOTS + 1), dtype=torch.int64, device=dev)
    lam[:, 0] = 1
    b = lam.clone()
    el = torch.zeros(B, dtype=torch.int64, device=dev)
    zcol = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    s_rev = s.flip(1)
    for r in range(1, P_NROOTS + 1):
        discr = _xor_reduce(gf.mul(lam[:, :r], s_rev[:, P_NROOTS - r:]))
        shift_b = torch.cat([zcol, b[:, :-1]], dim=1)
        upd = (2 * el <= r - 1) & (discr != 0)
        b = torch.where(upd[:, None],
                        gf.mul(lam, gf.inv(discr)[:, None]), shift_b)
        lam = lam ^ gf.mul(discr[:, None], shift_b)
        el = torch.where(upd, r - el, el)
    nu = torch.where(lam != 0, T["idx"], 0).amax(dim=1)

    at = _gf2_bytes(_byte_bits(lam, T["bit"]), T["roots"], P_N)  # [B, 204]
    is_root = at == 0
    # omega = s * lambda mod x^16, every coefficient
    k = T["idx"][:P_NROOTS]
    pair = k[None, :] <= k[:, None]                    # [i, j]: j <= i
    terms = gf.mul(s[:, torch.where(pair, k[:, None] - k[None, :], 0)],
                   lam[:, None, :P_NROOTS])
    omega = _xor_reduce(torch.where(pair, terms, 0))   # [B, 16]
    num = _gf2_bytes(_byte_bits(omega, T["bit"]), T["omega"], P_N)
    den = _gf2_bytes(_byte_bits(lam[:, 1::2], T["bit"]), T["deriv"], P_N)
    value = gf.mul(gf.mul(T["x"].expand(B, P_N), num), gf.inv(den))
    ok = dirty & (nu <= P_T) & (is_root.sum(dim=1) == nu) & \
        ~(is_root & (num == 0)).any(dim=1)
    count = torch.where(dirty, torch.where(ok, nu, -1), 0)
    fixed = torch.where(ok[:, None], data ^ torch.where(is_root, value, 0),
                        data)
    return count.to(torch.int32), fixed[:, :P_K].to(torch.uint8)


@functools.lru_cache(maxsize=8)
def _packet_consts(device: torch.device) -> tuple:
    """Kernel I's constants for RS(204,188) on ``device``: the field's
    tables, B's fragments of the 1632 x 128 product."""
    return (torch.from_numpy(_KERNEL_TABLES_NP).to(device),
            torch.from_numpy(_SYND204_FRAGMENTS_NP.view(np.int32))
            .to(device))


def rs_decode_packets(cw: torch.Tensor):
    """Decode RS(204,188) codewords, the rule of ETSI EN 300 744 4.3.2's
    code as a bounded-distance decoder:

    1. syndromes S_i = r(alpha^i), i = 0 .. 15 (byte j the coefficient of
       x^(203 - j)); all zero: count 0;
    2. Berlekamp-Massey gives lambda of degree nu; nu > 8: uncorrectable;
    3. the Chien search over the 204 sent positions only (position p the
       root alpha^(p + 52)); uncorrectable unless the roots number nu;
    4. Forney for a first root alpha^0: omega = S lambda mod x^16, the
       value X omega(alpha^i) / lambda'(alpha^i), X = alpha^(-i);
       uncorrectable where any value is zero;
    5. an uncorrectable codeword comes back as received with count -1;
       else with its values added, count nu.

    ``cw``: uint8[B, 204] (on the CPU any integer type, low bytes), rows
    any distance apart, bytes contiguous. Returns (count int32[B], data
    uint8[B, 188]) on its device. Kernel I's packets entry on a CUDA
    tensor, one launch; ``rs_decode_packets_plain`` on a CPU tensor."""
    if cw.device.type == "cpu":
        return rs_decode_packets_plain(cw)
    _card_only(cw, "rs_decode_packets")
    _check_packets(cw)
    if cw.dtype != torch.uint8:
        raise TypeError(f"rs_decode_packets: kernel I reads uint8 "
                        f"codewords, got {cw.dtype}")
    if cw.shape[0] and cw.stride(1) != 1:
        raise ValueError("rs_decode_packets: a codeword's bytes must be "
                         "contiguous")
    B, dev = cw.shape[0], cw.device
    count = torch.empty(B, dtype=torch.int32, device=dev)
    data = torch.empty((B, P_K), dtype=torch.uint8, device=dev)
    if B == 0:
        return count, data
    tables, frags = _packet_consts(dev)
    _build.RS_PACKETS.launch(
        dev, cw.data_ptr(), cw.stride(0) if B > 1 else P_N, B,
        tables.data_ptr(), frags.data_ptr(), count.data_ptr(),
        data.data_ptr(), _sms(dev.index))
    return count, data
