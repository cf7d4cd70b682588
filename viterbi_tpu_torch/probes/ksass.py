"""What the compiler made of the kernels: for every kernel of a built
library, its instruction count, the longest innermost loop (for kernels A and C
the six-step window) with its instructions a trellis step, and that loop's
instructions by opcode, read from ``cuobjdump -sass``.

Usage: python -m viterbi_tpu_torch.probes.ksass [--lib PATH] [--steps N]
       [--json PATH]

Without ``--lib`` the decode kernels' library is built (or found) as the
port builds it. ``--steps`` is the number of trellis steps one turn of
the longest loop makes (6).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
from pathlib import Path

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*)"
                    r"[.\w]*\s*(.*?);")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\s*$")


def find_cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/cuobjdump")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("cuobjdump not found")


def parse_sass(text: str) -> dict:
    """{kernel: [(address, opcode, operands), ...]} from cuobjdump's text."""
    kernels, cur = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = kernels.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return kernels


def longest_loop(instrs) -> tuple[int, int] | None:
    """(first, last) instruction index of the longest innermost loop: a
    backward branch with no other backward branch inside its span."""
    index = {addr: i for i, (addr, _, _) in enumerate(instrs)}
    spans = []
    for i, (addr, op, args) in enumerate(instrs):
        if op != "BRA":
            continue
        m = _TARGET.search(args)
        if m and int(m.group(1), 16) <= addr and int(m.group(1), 16) in index:
            spans.append((index[int(m.group(1), 16)], i))
    inner = [s for s in spans
             if not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                        for o in spans)]
    return max(inner, key=lambda s: s[1] - s[0], default=None)


def summarize(kernels: dict, steps: int = 6) -> dict:
    out = {}
    for name, instrs in kernels.items():
        row = {"instructions": len(instrs)}
        loop = longest_loop(instrs)
        if loop:
            body = instrs[loop[0]:loop[1] + 1]
            row["loop_instructions"] = len(body)
            row["per_step"] = len(body) / steps
            row["loop_opcodes"] = dict(collections.Counter(
                op for _, op, _ in body).most_common())
        out[name] = row
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lib", help="a built kernel library (default: the "
                                  "decode kernels', built at need)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--json", help="also write the table to this file")
    args = ap.parse_args(argv)
    lib = args.lib
    if lib is None:
        from ..ops import _build
        lib = str(_build.build())
    text = subprocess.run([find_cuobjdump(), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    table = summarize(parse_sass(text), args.steps)
    print(f"ksass: {lib}")
    for name, row in table.items():
        line = f"  {name}: {row['instructions']} instructions"
        if "per_step" in row:
            line += (f", longest loop {row['loop_instructions']} "
                     f"({row['per_step']:.1f} a step of {args.steps})")
        print(line)
        if "loop_opcodes" in row:
            print("    " + ", ".join(f"{op} {n}" for op, n in
                                     row["loop_opcodes"].items()))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"lib": lib, **table}, f, indent=1)
    return table


if __name__ == "__main__":
    main()
