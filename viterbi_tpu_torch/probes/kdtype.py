"""Narrow integer types on the card: which elementwise operations are
right and what they cost (kernel F), and chained add/min/xor rounds per
type (kernel G). Counterpart of ``scripts/kdtype.py``.

On a TPU the probe asked which u8 / i8 / u16 / i16 vector operations the
compiler accepts. A CUDA thread computes in 32-bit registers, so all of
them compile; what can pay off for the ACS kernels' 8-bit metrics is byte
SIMD, four u8 (or two u16) lanes in one register through the video
instructions. Both probes therefore have packed variants: ``"u8x4"`` and
``"u16x2"``.

Lane values travel as int32 tensors; the wrappers store them in the
kernel's type (and pack the lanes of a packed type into int32 words) and
bring the result back as int32 lane values. PyTorch lacks most uint16
arithmetic on the CPU, so the plain versions compute in int32 and wrap
to the type's width.

Usage: python -m viterbi_tpu_torch.probes.kdtype [--rounds N] [--iters N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import _build
from . import _common

#: kernel F's operations on a narrow type, in the C enum's order
OPS = ("add", "min", "cmp+select", "shift", "xor", "sub", "cvt->i32",
       "cmp->i32sel")
#: kernel F's packed operations: (type, op) in the C enum's order
PACKED_OPS = (("u8x4", "add"), ("u8x4", "addsat"), ("u8x4", "min"),
              ("u8x4", "sub"), ("u8x4", "cmp+select"), ("u16x2", "add"),
              ("u16x2", "min"))
OP_DTYPES = ("u8", "i8", "u16", "i16")           # C codes 0..3, 4 = packed
CHAIN_DTYPES = ("i32", "i16", "u16", "u8", "u8x4")   # C codes 0..4
OP_SHAPE = (32, 512)
CHAIN_SHAPE = (64, 8192)
CHAIN_ROUNDS = 3000
CHAIN_C, CHAIN_CAP, CHAIN_ONE = 3, 200, 1

_BITS = {"u8": 8, "i8": 8, "u16": 16, "i16": 16, "i32": 32}
_STORE = {"u8": torch.uint8, "i8": torch.int8, "u16": torch.int16,
          "i16": torch.int16, "i32": torch.int32}
# packed type -> (lane type, lanes per 32-bit word)
_PACKED = {"u8x4": ("u8", 4), "u16x2": ("u16", 2)}


def _wrap(v: torch.Tensor, dtype: str) -> torch.Tensor:
    """Integer values -> the value each has in ``dtype``'s width."""
    bits = _BITS[dtype]
    if bits == 32:
        return v.to(torch.int32)
    v = v & ((1 << bits) - 1)
    if dtype.startswith("i"):
        v = torch.where(v >= 1 << (bits - 1), v - (1 << bits), v)
    return v


def _to_storage(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """int32 lane values -> a contiguous tensor of the kernel's type;
    u16 travels as the int16 of the same 16 bits."""
    if dtype in _PACKED:
        lane, lanes = _PACKED[dtype]
        shifts = torch.arange(lanes, device=x.device) * _BITS[lane]
        words = (_wrap(x, lane).reshape(-1, lanes).to(torch.int64)
                 << shifts).sum(dim=1)
        return _wrap(words, "i32").contiguous()
    if dtype == "u16":
        x = _wrap(x, "i16")
    return x.to(_STORE[dtype]).contiguous()


def _from_storage(t: torch.Tensor, dtype: str, shape) -> torch.Tensor:
    """The kernel's output -> int32 lane values of ``shape``."""
    if dtype in _PACKED:
        lane, lanes = _PACKED[dtype]
        shifts = torch.arange(lanes, device=t.device) * _BITS[lane]
        v = (t.to(torch.int64)[:, None] >> shifts) & ((1 << _BITS[lane]) - 1)
        return v.to(torch.int32).reshape(shape)
    return _wrap(t.to(torch.int32), dtype).reshape(shape)


def _lane_dtype(dtype: str) -> str:
    return _PACKED[dtype][0] if dtype in _PACKED else dtype


def _check(x: torch.Tensor, dtype: str, known) -> None:
    if dtype not in known:
        raise ValueError(f"dtype must be one of {known}, got {dtype!r}")
    if x.dtype != torch.int32:
        raise ValueError(f"lane values must be int32, got {x.dtype}")
    if dtype in _PACKED and x.numel() % _PACKED[dtype][1]:
        raise ValueError(f"{dtype} needs a multiple of "
                         f"{_PACKED[dtype][1]} lanes, got {x.numel()}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _op_codes(op: str, dtype: str) -> tuple[int, int]:
    """The C interface's (type code, op code) of a (type, op) pair."""
    if dtype in _PACKED:
        if (dtype, op) not in PACKED_OPS:
            raise ValueError(f"no packed op {op!r} on {dtype}")
        return 4, PACKED_OPS.index((dtype, op))
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    return OP_DTYPES.index(dtype), OPS.index(op)


def _launch_op(codes, a, b, out) -> None:
    """Kernel F on stored operands of one type, one launch."""
    lib = _build.load(library=_build.PROBES)
    err = lib.kdtype_op_launch(
        *codes, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
        a.device.index or 0, _build.stream_arg(a.device))
    _build.check(lib, err, "kdtype_op")
    elementwise.launches += 1


def _launch_chain(dtype: str, a, out, rounds: int) -> None:
    """Kernel G on stored lanes of one type, one launch."""
    lib = _build.load(library=_build.PROBES)
    err = lib.kdtype_chain_launch(
        CHAIN_DTYPES.index(dtype), a.data_ptr(), out.data_ptr(), a.numel(),
        rounds, CHAIN_C, CHAIN_CAP, CHAIN_ONE, a.device.index or 0,
        _build.stream_arg(a.device))
    _build.check(lib, err, "kdtype_chain")
    chain.launches += 1


def elementwise_plain(op: str, dtype: str, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel F: the operation in int32, wrapped to the
    lane type's width."""
    lane = _lane_dtype(dtype)
    x, y = _wrap(x, lane), _wrap(y, lane)
    if op in ("add", "cvt->i32"):
        r = x + y
    elif op == "addsat":
        r = (x + y).clamp(max=(1 << _BITS[lane]) - 1)
    elif op == "min":
        r = torch.minimum(x, y)
    elif op == "cmp+select":
        r = torch.where(x <= y, x, y)
    elif op == "shift":
        r = _wrap(x + y, lane) >> 1
    elif op == "xor":
        r = x ^ y
    elif op == "sub":
        r = x - y
    elif op == "cmp->i32sel":
        r = (x <= y).to(torch.int32)
    else:
        raise ValueError(f"unknown op {op!r}")
    return _wrap(r, lane).to(torch.int32)


def elementwise(op: str, dtype: str, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """One elementwise operation in a narrow type.

    ``x``, ``y``: int32 lane values of one shape. ``dtype``: u8, i8, u16
    or i16 with an op of ``OPS``, or a packed pair of ``PACKED_OPS``.
    Returns the int32 lane values of the result.

    Kernel F on CUDA tensors, the plain version on CPU tensors;
    ``elementwise.launches`` counts the kernel's launches.
    """
    _check(x, dtype, OP_DTYPES + tuple(_PACKED))
    if y.shape != x.shape or y.dtype != x.dtype or y.device != x.device:
        raise ValueError("x and y must agree in shape, type and device")
    codes = _op_codes(op, dtype)
    if x.device.type == "cpu":
        return elementwise_plain(op, dtype, x, y)
    a, b = _to_storage(x, dtype), _to_storage(y, dtype)
    out = torch.empty_like(a)
    if a.numel():
        _launch_op(codes, a, b, out)
    return _from_storage(out, dtype, x.shape)


elementwise.launches = 0


def chain_plain(x: torch.Tensor, rounds: int, dtype: str) -> torch.Tensor:
    """Plain version of kernel G: ``rounds`` times v = min(v + 3, 200);
    v = min(v, v + 1); v ^= 3 in int32, each add wrapped to the lane
    type's width."""
    lane = _lane_dtype(dtype)
    v = _wrap(x, lane)
    for _ in range(rounds):
        v = torch.clamp(_wrap(v + CHAIN_C, lane), max=CHAIN_CAP)
        v = torch.minimum(v, _wrap(v + CHAIN_ONE, lane))
        v = v ^ CHAIN_C
    return v.to(torch.int32)


def chain(x: torch.Tensor, rounds: int, dtype: str) -> torch.Tensor:
    """Chained rounds of add/min/xor in one integer type.

    ``x``: int32 lane values in [0, 203] (so no type wraps: every type
    gives the same lanes); ``dtype`` one of ``CHAIN_DTYPES``. Returns the
    int32 lane values after ``rounds`` rounds.

    Kernel G on a CUDA tensor, the plain version on a CPU tensor;
    ``chain.launches`` counts the kernel's launches.
    """
    _check(x, dtype, CHAIN_DTYPES)
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if x.device.type == "cpu":
        return chain_plain(x, rounds, dtype)
    a = _to_storage(x, dtype)
    out = torch.empty_like(a)
    if a.numel():
        _launch_chain(dtype, a, out, rounds)
    return _from_storage(out, dtype, x.shape)


chain.launches = 0


def run_ops(iters: int = 50) -> list[dict]:
    """Kernel F's table: every (type, op) against its plain version on
    ``OP_SHAPE`` random lanes, with the launch's time."""
    dev = _common.require_card()
    rng = np.random.default_rng(0)
    rows = []
    for dtype, op in [(d, o) for d in OP_DTYPES for o in OPS] \
            + list(PACKED_OPS):
        lane = _lane_dtype(dtype)
        lo = -(1 << (_BITS[lane] - 1)) if lane.startswith("i") else 0
        x, y = (torch.from_numpy(rng.integers(
            lo, lo + (1 << _BITS[lane]), OP_SHAPE).astype(np.int32)).to(dev)
            for _ in range(2))
        got = elementwise(op, dtype, x, y)
        right = torch.equal(got, elementwise_plain(op, dtype, x, y))
        # the launch alone: storage conversion stays outside the timing
        a, b = _to_storage(x, dtype), _to_storage(y, dtype)
        out = torch.empty_like(a)
        codes = _op_codes(op, dtype)
        rows.append({"dtype": dtype, "op": op, "right": bool(right),
                     "ns": 1e6 * _common.device_ms(
                         lambda: _launch_op(codes, a, b, out), iters)})
    return rows


def run_chain(rounds: int = CHAIN_ROUNDS, iters: int = 10) -> list[dict]:
    """Kernel G's table: ms and lane-operations per second per type on
    ``CHAIN_SHAPE`` lanes (five operations a round)."""
    dev = _common.require_card()
    x = torch.ones(CHAIN_SHAPE, dtype=torch.int32, device=dev)
    want = chain_plain(x[:1, :64], rounds, "i32")
    rows = []
    for dtype in CHAIN_DTYPES:
        a = _to_storage(x, dtype)
        out = torch.empty_like(a)
        half_ms = _common.device_ms(
            lambda: _launch_chain(dtype, a, out, rounds // 2), iters)
        ms = _common.device_ms(
            lambda: _launch_chain(dtype, a, out, rounds), iters)
        got = _from_storage(out, dtype, x.shape)
        rows.append({"dtype": dtype, "ms": ms, "half_rounds_ms": half_ms,
                     "right": bool(torch.equal(got[:1, :64], want)
                                   and torch.equal(got, got[:1, :1]
                                                   .expand_as(got))),
                     "lane_ops_per_s": x.numel() * rounds * 5 / (ms * 1e-3)})
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=CHAIN_ROUNDS)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    _common.require_card()
    card = _common.card_line()
    ops = run_ops(max(args.iters, 50))
    print(f"kdtype ops on {card}: one op over {OP_SHAPE} lanes "
          f"(a launch's time, not the op's)")
    for r in ops:
        print(f"  {r['dtype']:6s} {r['op']:12s} compiles  "
              f"{'right' if r['right'] else 'WRONG'}  {r['ns']:8.0f} ns")
    rows = run_chain(args.rounds, args.iters)
    print(f"kdtype chain on {card}: {args.rounds} rounds over {CHAIN_SHAPE} "
          f"lanes")
    for r in rows:
        print(f"  {r['dtype']:6s} {r['ms']:8.3f} ms  "
              f"(half the rounds {r['half_rounds_ms']:8.3f} ms)  "
              f"{r['lane_ops_per_s'] / 1e12:6.2f} T lane-ops/s  "
              f"{'right' if r['right'] else 'WRONG'}")
    return {"ops": ops, "chain": rows}


if __name__ == "__main__":
    main()
