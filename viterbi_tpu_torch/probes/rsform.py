"""Two exact forms of the RS decoder's GF(256) arithmetic, timed against
each other on the card.

``ops.rs`` computes the field through the reference's log/antilog tables
(a gather is one small launch on a GPU). The JAX package computes it
gather-free, for a machine where gathers are slow: a carryless multiply,
the Fermat inverse and square-and-multiply powers. That bitwise form is
kept here, outside the decode path, as the cross-check of the tables and
for this timing. It launches no hand-written kernel: both forms are
plain PyTorch, as the JAX module has no kernel either.

Usage: python -m viterbi_tpu_torch.probes.rsform [--codewords N] [--iters N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import constants as C
from .. import golden
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
    """``ops.rs.rs_decode_blocks`` with the bitwise field: the same
    decoder, bit for bit the same result."""
    return rs_ops.decode_with_field(blocks, Bitwise)


FORMS = {"table": rs_ops.rs_decode_blocks,
         "bitwise": rs_decode_blocks_bitwise}


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
    """Both forms on every mix: equal to each other, counts as planted,
    three codewords equal to the golden model; ms and device launches."""
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
        for form, decode in FORMS.items():
            results[form] = decode(blocks)
            rows.append({
                "mix": mix, "form": form,
                "ms": _common.device_ms(lambda: decode(blocks), iters, 1),
                "launches": _common.count_launches(lambda: decode(blocks))})
        (c_t, d_t), (c_b, d_b) = results["table"], results["bitwise"]
        if not (torch.equal(c_t, c_b) and torch.equal(d_t, d_b)):
            raise AssertionError(f"{mix}: the two forms disagree")
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
          f"codewords; forms equal, counts as planted")
    for r in rows:
        print(f"  {r['mix']:17s} {r['form']:8s} {r['ms']:8.2f} ms  "
              f"{args.codewords / r['ms'] / 1e3:6.2f} M codewords/s  "
              f"{r['launches']} launches")
    return rows


if __name__ == "__main__":
    main()
