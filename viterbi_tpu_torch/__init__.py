"""viterbi_tpu_torch — the PyTorch/CUDA port of ``viterbi_tpu``.

The DAB mother-code Viterbi decoder (K=7, rate 1/4, 64 states) and the
RS(120,110) superframe check with the reference DLL's export surface,
the DAB+ audio-superframe chain and EEP/UEP puncturing (``models``), on
an NVIDIA Hopper card through hand-written CUDA kernels (``csrc/``): the
fused register-exchange ACS and the checkpoint-walk traceback on the
main path, the decisions kernel and its word walk on the ``cuda_words``
rung, and the timing probes of ``probes``. Every entry point decodes on
the card unless the caller asks for the CPU (``device="cpu"``, CPU
tensors, or ``initialize(device="cpu")``), and raises
``runtime.placement.NoDeviceError`` where there is no card; on the CPU
the kernels run as their plain torch versions.

This package imports torch and numpy only — never jax, never
``viterbi_tpu``.
"""

from . import constants  # noqa: F401
from . import golden     # noqa: F401
from .api import (  # noqa: F401
    deconvolve,
    deconvolve_batch,
    get_caps,
    initialize,
    last_output,
    last_rs_output,
    rs_check_superframe,
    wake_up,
)

__version__ = "0.1.0"
