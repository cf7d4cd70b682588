"""Where an entry point's input goes, and whether it takes the kernels.

One rule for every entry point of the port (the API's dispatcher, the
DAB chains, tail-biting, streaming, sessions, the pipelined feed, the
tools and the ranks of ``parallel.distributed``): a call runs on the
card unless the caller asks for the CPU, and raises ``NoDeviceError``
where it would need a card and there is none. A tensor stays on its
device unless the caller names another, so a CPU tensor is the caller's
request for the CPU; a host array goes to ``strict_device(device)``.
``use_kernels=None`` then takes the hand-written kernels on a CUDA
tensor and the plain torch path on a CPU tensor; ``use_kernels=True`` on
the CPU is refused, since there the kernels exist only as their plain
versions.

``ingest`` is the one place where a call's input goes to the decode
device (``on_device``, and the API's exports through it); it carries the
``ingest`` span of ``runtime.calllog`` and its counters.
"""

from __future__ import annotations

import numpy as np
import torch

from . import calllog

_NUMPY = {torch.int32: np.int32, torch.uint8: np.uint8}


class NoDeviceError(RuntimeError):
    """A card was asked for, by name or by default, and there is none."""


def strict_device(device=None) -> torch.device:
    """The device of a call: the current card, unless the caller names
    another (``"cpu"``). Raises ``NoDeviceError`` where a card is asked
    for, by name or by default, and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(f"no CUDA device (no card for {dev}): pass "
                                "device='cpu' (--device cpu) to run on the "
                                "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(symbols, device=None) -> torch.Tensor:
    """Symbols as an int32 tensor on the decode device: a tensor stays
    where it is unless ``device`` names another; a host array goes to
    ``strict_device(device)``."""
    if isinstance(symbols, torch.Tensor) and device is None:
        return ingest(symbols, symbols.device)
    return ingest(symbols, strict_device(device))


def ingest(data, device: torch.device, dtype=torch.int32) -> torch.Tensor:
    """``data`` (a host array or a tensor) as a ``dtype`` tensor on
    ``device``, in the span ``ingest``. Its counter ``h2d_bytes``: the
    bytes handed over from host memory (0 from a card; on the CPU the
    bytes the decode then reads in place)."""
    with calllog.span("ingest") as sp:
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data,
                                                         dtype=_NUMPY[dtype]))
        if sp:
            sp.count(h2d_bytes=data.numel() * dtype.itemsize
                     if data.device.type == "cpu" else 0)
        return data.to(device, dtype)


def want_kernels(use_kernels: bool | None, device: torch.device) -> bool:
    """Whether a call on ``device`` runs the kernels: by default where the
    device is a card; ``True`` on another device raises."""
    on_card = torch.device(device).type == "cuda"
    if use_kernels and not on_card:
        raise ValueError("use_kernels=True needs symbols on a CUDA device, "
                         f"got {device}")
    return on_card if use_kernels is None else bool(use_kernels)
