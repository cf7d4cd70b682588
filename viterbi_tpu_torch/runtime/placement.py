"""Where an entry point's input goes, and whether it takes the kernels.

Every decode entry point beyond ``api`` (the DAB chains, tail-biting,
streaming, sessions) takes a tensor or a host array. A tensor stays on
its device unless the caller names another; a host array goes to the
card where there is one. ``use_kernels=None`` then takes the
hand-written kernels on a CUDA tensor and the plain torch path on a CPU
tensor; ``use_kernels=True`` on the CPU is refused, since there the
kernels exist only as their plain versions. The entry points of
``entry.py``, the tools and the ranks of ``parallel.distributed`` take
``strict_device`` instead: the card, or the CPU only when asked for.
"""

from __future__ import annotations

import numpy as np
import torch


def default_device(device=None) -> torch.device:
    """``device``, or the card where there is one, else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def strict_device(device=None) -> torch.device:
    """The device of a call that must not move to the CPU by itself: the
    current card, unless the caller names another (``"cpu"``). Raises
    where a card is asked for, by name or by default, and there is
    none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device (no card for {dev}): pass "
                               "device='cpu' (--device cpu) to run on the "
                               "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(symbols, device=None) -> torch.Tensor:
    """Symbols as an int32 tensor on the decode device: a tensor stays
    where it is unless ``device`` says otherwise; a host array goes to
    ``default_device(device)``."""
    if isinstance(symbols, torch.Tensor):
        return symbols.to(device=device or symbols.device, dtype=torch.int32)
    return torch.from_numpy(np.ascontiguousarray(symbols, dtype=np.int32)) \
        .to(default_device(device))


def want_kernels(use_kernels: bool | None, device: torch.device) -> bool:
    """Whether a call on ``device`` runs the kernels: by default where the
    device is a card; ``True`` on another device raises."""
    on_card = torch.device(device).type == "cuda"
    if use_kernels and not on_card:
        raise ValueError("use_kernels=True needs symbols on a CUDA device, "
                         f"got {device}")
    return on_card if use_kernels is None else bool(use_kernels)
