"""The reference's depuncturing: punctured soft symbols put back into the
rate-1/4 mother stream that the plain reference decodes.

A frozen copy of ``depuncture`` of ``viterbi_tpu_torch/models/puncture.py``
at commit 401e62929c97d2b388facf2e236f3a3789358ad0, here in torch on any
device: each received symbol at its kept position, the neutral soft value
127 at every punctured one. The kept positions are the benchmark's own
EEP masks (``gen/channel.eep_mask``, a frozen copy of the same module's
tables), not the program's. Imports torch and numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

NEUTRAL = 127


def depuncture(received: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
    """[..., mask.sum()] soft symbols -> int32[..., mask.size] on their
    device; punctured positions hold 127."""
    mask = np.asarray(mask, dtype=bool)
    if received.shape[-1] != int(mask.sum()):
        raise ValueError(f"received has {received.shape[-1]} symbols a "
                         f"frame, the mask keeps {int(mask.sum())}")
    keep = torch.from_numpy(np.nonzero(mask)[0]).to(received.device)
    out = torch.full(received.shape[:-1] + (mask.size,), NEUTRAL,
                     dtype=torch.int32, device=received.device)
    out[..., keep] = received.to(torch.int32)
    return out
