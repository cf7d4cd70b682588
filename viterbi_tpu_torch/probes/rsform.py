"""Two exact forms of the RS decoder's GF(256) arithmetic and kernel I in
both its syndrome forms, timed against each other on the card.

``ops.rs``'s plain version computes the field through the reference's
log/antilog tables (a gather is one small launch on a GPU). The JAX
package computes it gather-free, for a machine where gathers are slow: a
carryless multiply, the Fermat inverse and square-and-multiply powers.
That bitwise form is kept here, outside the decode path, as the
cross-check of the tables and for this timing. Both are plain PyTorch,
some 340 launches a call. The third row is kernel I
(``ops.rs.rs_decode_blocks`` on the card, ``csrc/rs_decode.cu``: the
syndromes as a binary tensor-core product), the fourth the same device
code with the syndromes through the tables (``csrc/probes/rs_synd.cu``,
``rs_decode_blocks_table_synd``), one launch each, all four held bit for
bit against each other.

Usage: python -m viterbi_tpu_torch.probes.rsform [--codewords N] [--iters N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import constants as C
from .. import golden
from ..ops import _build
from ..ops import rs as rs_ops
from . import _common

CODEWORDS = 65536
#: error mix -> (share of dirty codewords, most errors in one, codewords
#: with nine errors, which RS cannot correct)
MIXES = {"clean-dominated": (0.25, 1, 0), "all dirty": (1.0, 5, 0),
         "64 uncorrectable": (0.25, 5, 64)}

# alpha^(2^k) for square-and-multiply exponentiation
_A2K = [int(rs_ops._ATO_NP[(1 << k) % 255]) for k in range(8)]


def _reduce(acc: torch.Tensor) -> torch.Tensor:
    """Reduce a carryless product (< 2^15) mod the field polynomial."""
    for k in range(14, 7, -1):
        acc = acc ^ (((acc >> k) & 1) * (C.RS_GFPOLY << (k - 8)))
    return acc


def gf_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact GF(256) product, gather-free: a carryless multiply (eight
    conditional-XOR rounds), then reduction mod 0x11D."""
    a, b = torch.broadcast_tensors(a, b)
    acc = torch.zeros_like(a)
    for k in range(8):
        acc = acc ^ (((b >> k) & 1) * (a << k))
    return _reduce(acc)


def _gf_mul_const(a: torch.Tensor, b: int) -> torch.Tensor:
    """``gf_mul`` by a constant: popcount(b) shift-xors."""
    acc = torch.zeros_like(a)
    for k in range(8):
        if (b >> k) & 1:
            acc = acc ^ (a << k)
    return _reduce(acc)


def gf_inv(x: torch.Tensor) -> torch.Tensor:
    """Fermat inverse x^254 (gf_inv(0) == 0), 13 ``gf_mul``s."""
    p = acc = gf_mul(x, x)                # x^2
    for _ in range(6):
        p = gf_mul(p, p)                  # x^4 .. x^128
        acc = gf_mul(acc, p)
    return acc


def gf_pow_alpha(e: torch.Tensor) -> torch.Tensor:
    """alpha^e for integer exponents e in [0, 255], square-and-multiply
    over the constants alpha^(2^k)."""
    acc = torch.ones_like(e)
    for k in range(8):
        acc = torch.where((e >> k) & 1 != 0, _gf_mul_const(acc, _A2K[k]),
                          acc)
    return acc


class Bitwise:
    """The field as the JAX package computes it, with the interface of
    ``ops.rs``'s table field."""
    mul = staticmethod(gf_mul)
    inv = staticmethod(gf_inv)
    pow_alpha = staticmethod(gf_pow_alpha)

    @staticmethod
    def root_powers(root: torch.Tensor) -> torch.Tensor:
        """[B, 10] root exponents -> alpha^(k*root), [B, 10, 10] over k."""
        alpha_r = gf_pow_alpha(root)
        pw = [torch.ones_like(alpha_r)]
        for _ in range(C.RS_NROOTS - 1):
            pw.append(gf_mul(pw[-1], alpha_r))
        return torch.stack(pw, dim=2)


def rs_decode_blocks_bitwise(blocks: torch.Tensor):
    """``ops.rs.rs_decode_blocks_plain`` with the bitwise field: the same
    decoder, bit for bit the same result."""
    return rs_ops.decode_with_field(blocks, Bitwise)


def rs_decode_blocks_table_synd(blocks: torch.Tensor):
    """``ops.rs.rs_decode_blocks`` through kernel I's device code with the
    other syndrome form, the tables (``csrc/probes/rs_synd.cu``), on a
    card tensor; its plain version on a CPU tensor."""
    if blocks.device.type == "cpu":
        return rs_ops.rs_decode_blocks_plain(blocks)
    return rs_ops.launch_codewords(_build.RS_TABLE_DECODE, blocks,
                                   "rs_decode_blocks_table_synd")


def rs_check_superframes_table_synd(sf: torch.Tensor, rs_dims: int, *,
                                    zero_after_fail: bool):
    """``ops.rs.rs_check_superframes`` with the table syndrome form, as
    ``rs_decode_blocks_table_synd``."""
    if sf.device.type == "cpu":
        return rs_ops.rs_check_superframes_plain(
            sf, rs_dims, zero_after_fail=zero_after_fail)
    return rs_ops.launch_superframes(_build.RS_TABLE_SUPERFRAMES, sf,
                                     rs_dims, zero_after_fail, None,
                                     "rs_check_superframes_table_synd")

FORMS = {"table": rs_ops.rs_decode_blocks_plain,
         "bitwise": rs_decode_blocks_bitwise}
#: kernel I in its two syndrome forms (on a CPU tensor its plain version)
KERNELS = {"kernel": rs_ops.rs_decode_blocks,
           "kernel_table_synd": rs_decode_blocks_table_synd}
#: where the launch path counts each form's launches
_LAUNCHED = {"kernel": _build.RS_DECODE,
             "kernel_table_synd": _build.RS_TABLE_DECODE}
#: the rows of the table: both field forms, then kernel I's two forms
DECODERS = {**FORMS, **KERNELS}


def corrupt_mix(rng, base, frac, max_errs, uncorrectable=0):
    """A share ``frac`` of the codewords gets 1..max_errs byte errors; the
    first ``uncorrectable`` get nine (more than RS corrects). Returns the
    corrupted codewords and each one's error count."""
    cws = base.copy()
    n = len(cws)
    pos = rng.random((n, C.RS_N)).argsort(axis=1)[:, :9]   # distinct places
    vals = rng.integers(1, 256, (n, 9))
    nerr = np.where(rng.random(n) < frac,
                    rng.integers(1, max_errs + 1, n), 0)
    nerr[:uncorrectable] = 9
    use = np.arange(9)[None, :] < nerr[:, None]
    flat = (np.arange(n)[:, None] * C.RS_N + pos)[use]
    np.bitwise_xor.at(cws.reshape(-1), flat, vals[use])
    return cws, nerr


def run(codewords: int = CODEWORDS, iters: int = 3) -> list[dict]:
    """Every form on every mix: equal to each other, counts as planted,
    three codewords equal to the golden model; ms, the row's kernel's
    launches (the launch path's count; 0 for the field forms) and device
    launches (the profiler's) a call."""
    dev = _common.require_card()
    rng = np.random.default_rng(5)
    clean = np.tile(golden.rs_encode_many(rng.integers(
        0, 256, (256, C.RS_KK), dtype=np.uint8)).astype(np.int32),
        (-(-codewords // 256), 1))[:codewords]
    rows = []
    for mix, (frac, max_errs, bad) in MIXES.items():
        cws, nerr = corrupt_mix(rng, clean, frac, max_errs, bad)
        blocks = torch.from_numpy(cws).to(dev)
        results = {}
        for form, decode in DECODERS.items():
            # the row's kernel's launches a call, from its count over the
            # result's call and the timed ones (the warm-up among them)
            before = {k: f.launches for k, f in _LAUNCHED.items()}
            results[form] = decode(blocks)
            ms = _common.device_ms(lambda: decode(blocks), iters, 1)
            launched = {k: f.launches - before[k]
                        for k, f in _LAUNCHED.items()}
            per_call, rem = divmod(launched.pop(form, 0), iters + 2)
            if rem or any(launched.values()):
                raise AssertionError(f"{mix} {form}: {per_call} a call, "
                                     f"others {launched}, in {iters + 2} "
                                     f"calls")
            rows.append({
                "mix": mix, "form": form, "ms": ms,
                "kernel_launches": per_call,
                "launches": _common.count_launches(lambda: decode(blocks))})
        c_t, d_t = results["table"]
        for form, (c, d) in results.items():
            if not (torch.equal(c, c_t) and torch.equal(d, d_t)):
                raise AssertionError(f"{mix}: the {form} form differs from "
                                     f"the table form")
        count, fixed = c_t.cpu().numpy(), nerr <= 5
        if not (np.array_equal(count[fixed], nerr[fixed])
                and (count[~fixed] == -1).all()
                and np.array_equal(d_t.cpu().numpy()[fixed], clean[fixed])):
            raise AssertionError(f"{mix}: counts or bytes not as planted")
        for i in (0, 1, codewords - 1):
            g_count, g_corr = golden.rs_decode_codeword(cws[i])
            if count[i] != g_count or not np.array_equal(
                    d_t[i].cpu().numpy(), g_corr):
                raise AssertionError(f"{mix}: codeword {i} != golden")
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--codewords", type=int, default=CODEWORDS)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    _common.require_card()
    rows = run(args.codewords, args.iters)
    print(f"rs_decode_blocks on {_common.card_line()}: {args.codewords} "
          f"codewords; the field forms and kernel I's two forms equal, "
          f"counts as planted")
    for r in rows:
        print(f"  {r['mix']:17s} {r['form']:17s} {r['ms']:8.4f} ms  "
              f"{args.codewords / r['ms'] / 1e3:7.2f} M codewords/s  "
              f"{r['launches']} launches ({r['kernel_launches']} of the "
              f"row's kernel)")
    return rows


if __name__ == "__main__":
    main()
