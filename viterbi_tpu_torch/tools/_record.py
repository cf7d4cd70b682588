"""What the tools share, the twin of ``scripts/benchutil.py``: the card's
stamp on every record, the timers, the record writer, and (from
``ops.counts``) the kernels' launch counts. The card's name and power
limit and the CUDA-event timer are ``probes._common``'s; the device a
tool runs on is ``runtime.placement.strict_device``."""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.counts import (  # noqa: F401  (the tools' launch counts)
    KERNELS, launches, missing, only, zero_launches)
from ..probes import _common

#: where the records go by default: the repository's root
ROOT = Path(__file__).resolve().parents[2]


def stamp(dev: torch.device) -> dict:
    """What a record says of where it was taken: on a card its name and
    power limit as ``nvidia-smi`` gives them, torch's name for it and the
    count of cards; elsewhere the platform alone."""
    if dev.type != "cuda":
        return {"platform": dev.type}
    return {"platform": "gpu", "card": _common.card_line(),
            "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count()}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_ms(fn, dev: torch.device, iters: int, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back runs after ``warmup``:
    CUDA events on a card (``probes._common.device_ms``), the host's clock
    on the CPU."""
    if dev.type == "cuda":
        return _common.device_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def _to_host(out):
    """Read a call's result back to the host; a tensor's read-back waits
    for the device."""
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, (tuple, list)):
        return [_to_host(o) for o in out]
    return out


def per_call_ms(fn, iters: int, warmup: int = 10) -> np.ndarray:
    """Wall ms of each of ``iters`` calls of ``fn``, every call ended by
    reading its result back to the host (the shape of a live call)."""
    for _ in range(warmup):
        _to_host(fn())
    lat = np.empty(iters)
    for i in range(iters):
        t0 = time.perf_counter()
        _to_host(fn())
        lat[i] = 1e3 * (time.perf_counter() - t0)
    return lat


def percentiles(lat_ms: np.ndarray) -> dict:
    p50, p99 = np.percentile(lat_ms, [50, 99])
    return {"p50_ms": float(p50), "p99_ms": float(p99)}


@contextlib.contextmanager
def recorded(module, name):
    """Record the calls of ``module.name`` made inside the block as
    (arguments, keyword arguments, result); the function runs as before
    (its launches counted by the launch path)."""
    fn, calls = getattr(module, name), []

    def rec(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def parser(doc: str) -> argparse.ArgumentParser:
    """A tool's command line: ``--device`` (default: the card) and
    ``--out`` (default: ``<NAME>_GPU.json`` at the repository's root on a
    card, no file elsewhere)."""
    ap = argparse.ArgumentParser(
        description=doc.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU at the plain versions "
                         "(default: the card; without one it fails)")
    ap.add_argument("--out", default=None, help="the record's path")
    return ap


def write(doc: dict, path) -> Path:
    """Write a record. One taken off the card is never written under a
    ``_GPU.json`` name."""
    path = Path(path)
    if doc["device"]["platform"] != "gpu" and "_GPU" in path.name:
        raise ValueError(f"a record taken on {doc['device']['platform']} "
                         f"is not written as {path.name}")
    path.write_text(json.dumps(doc, indent=1) + "\n")
    return path


def finish(doc: dict, out, name: str) -> int:
    """Write ``doc`` (to ``out``, or on a card ``<name>_GPU.json`` at the
    repository's root) and say so; the exit code: 0 only if ``ok``."""
    if out is None and doc["device"]["platform"] == "gpu":
        out = ROOT / f"{name}_GPU.json"
    if out is not None:
        print(f"wrote {write(doc, out)}")
    print(json.dumps({"ok": doc["ok"], "device": doc["device"]}))
    return 0 if doc["ok"] else 1
