"""The RS decoder's reference traps as fixed codewords, for the CPU tests
of kernel I's schedule (``test_torch_rs.py``) and its card tests
(``test_torch_kernels.py``); imports nothing of JAX.

Each trap is a word found by decoding random words made with numpy's
``default_rng(seed).integers(0, 256, (N, 120))``: the first such word
among them, ``index``."""

from __future__ import annotations

import numpy as np

from viterbi_tpu_torch import constants as C

TRAPS = {
    # correctable (count > 0) with a root inside the shortening pad: the
    # root counts and changes no byte
    "root_in_pad": (0, 271),
    # a root past the pad whose Forney numerator num1 is 0: it changes
    # nothing (the log of 0 would index the antilog table's end)
    "num1_zero": (3, 35881),
    # the Chien search finds fewer roots than deg lambda: -1, unchanged
    "degree_mismatch": (0, 0),
}


def trap_word(name: str) -> np.ndarray:
    """The trap's codeword, int64[120]."""
    seed, index = TRAPS[name]
    return np.random.default_rng(seed).integers(0, 256,
                                                (index + 1, C.RS_N))[index]
