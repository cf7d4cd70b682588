"""Variant dispatch + capability probe — the L3 analog of the reference's
CPU dispatcher (setupdll.cpp:195-270, viterbi_helpers.asm:48-157).

The reference probes CPUID and picks the best of its SIMD kernels behind
a function pointer; here the probe is the torch backend (a CUDA device,
the Hopper kernels built from ``csrc/``) and the choice is a decoder
*variant*. A config override is honored only "downward-compatible":
forcing a variant the backend cannot run keeps the automatic choice
(setupdll.cpp:220-236). With a CUDA device the kernels must build:
a failed build raises instead of quietly dropping to the plain path.

The dispatcher is set up at first use (``ready()``), as the reference
sets itself up when the DLL loads (``DllMain(DLL_PROCESS_ATTACH)``,
dllmain.cpp:208-256), on the device ``placement.strict_device`` gives:
the current card, or a raise where there is none. ``initialize(device=)``
names another device (``"cpu"``); a later ``initialize()`` keeps it.

The choice is re-armed by ``initialize()`` and latched to a safe-mode
stub by the fault handler (runtime.faults), mirroring ``decon_savemode``
(exc_handler.cpp:214,243).
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from ..ops import _build
from . import calllog
from . import config as config_mod
from .placement import strict_device

# Capability bits (analog of getcpucaps.h:29-38).
CAP_TORCH = 1 << 0         # plain-torch decode available
CAP_BLOCKED_TB = 1 << 1    # block-parallel traceback
CAP_KERNELS = 1 << 2       # the Hopper kernels are built and loaded
CAP_CUDA = 1 << 3          # a CUDA device is present
CAP_MULTI_DEVICE = 1 << 4  # more than one CUDA device

# Variant table, "weakest" to "strongest". Index is what the config
# file's byte 0 selects.
VARIANTS = (
    "torch_scan",    # 0: plain-torch ACS + serial-scan traceback
    "torch_blocked",  # 1: plain-torch ACS + block-parallel traceback
    "cuda_words",    # 2: decisions kernel + decision-word walk kernel
    "cuda_fused",    # 3: register-exchange ACS kernel + checkpoint walk
    "auto_best",     # 4: alias: best supported variant
)


def get_caps(build_root: str | None = None) -> int:
    """Probe backend capabilities. Analog of GetCPUCaps. With a CUDA
    device this builds the kernels on first use and raises if they do
    not build."""
    caps = CAP_TORCH | CAP_BLOCKED_TB
    if torch.cuda.is_available():
        caps |= CAP_CUDA
        _build.load(build_root)
        caps |= CAP_KERNELS
        if torch.cuda.device_count() > 1:
            caps |= CAP_MULTI_DEVICE
    return caps


def _variant_supported(index: int, caps: int) -> bool:
    if index in (0, 1):
        return bool(caps & CAP_TORCH)
    if index in (2, 3):
        return bool(caps & CAP_KERNELS)
    return index == 4


def _best_variant(caps: int) -> int:
    # cuda_fused (register exchange, no decisions array) first; cuda_words
    # only by an override or the tuner's choice
    for index in (3, 1, 0):
        if _variant_supported(index, caps):
            return index
    return 0


@dataclasses.dataclass
class DispatchState:
    """The mutable dispatcher: chosen variant, device and safe-mode latch.
    ``device`` is None until the first set-up.

    Mirrors VITDLLMEM + deconJumpTarget (viterbi.h:117-129,
    setupdll.cpp:39).
    """
    caps: int = 0
    variant: int = 0
    device: torch.device | None = None
    safe_mode: bool = False     # latched by faults, cleared by initialize()
    except_counter: int = 0
    config: config_mod.Config = dataclasses.field(
        default_factory=config_mod.Config)


_STATE = DispatchState()
_SETUP_LOCK = threading.RLock()


def state() -> DispatchState:
    return _STATE


def setup(config_path: str | None = None, device=None) -> DispatchState:
    """(Re)configure the dispatcher: read the config, probe caps, pick the
    variant and the device, configure the call log. Analog of SetupDLL +
    SetupCpuDispatcher (setupdll.cpp:57-270). The device is ``device``,
    else the one of the last set-up, else ``strict_device(None)``: the
    current card, or ``NoDeviceError`` where there is none."""
    with _SETUP_LOCK:
        dev = strict_device(_STATE.device if device is None else device)
        cfg = config_mod.load(config_path)
        caps = get_caps(cfg.compile_cache)
        variant = _best_variant(caps)
        if 0 <= cfg.variant_override <= 3 \
                and _variant_supported(cfg.variant_override, caps):
            variant = cfg.variant_override  # downgrade always honored
        # '4' and unsupported upgrade requests keep the automatic choice
        _STATE.caps = caps
        _STATE.variant = variant
        _STATE.config = cfg
        _STATE.safe_mode = False
        calllog.configure(cfg.log_calls, cfg.log_symbols)
        _STATE.device = dev      # last: ready() reads it without the lock
        if cfg.show_info:
            print(f"[viterbi_tpu_torch] variant={VARIANTS[variant]} "
                  f"caps=0x{caps:x} device={dev}")
    return _STATE


def ready() -> DispatchState:
    """The dispatcher, set up once at first use where nothing has set it
    up yet (the reference's set-up at load); concurrent first calls set
    it up once."""
    if _STATE.device is None:
        with _SETUP_LOCK:
            if _STATE.device is None:
                setup()
    return _STATE


def initialize(config_path: str | None = None, *, device=None) -> bool:
    """Public re-init: clears the exception counter and safe-mode latch,
    re-reads the config and keeps the device unless ``device`` names
    another (dllmain.cpp:156-160)."""
    with _SETUP_LOCK:
        _STATE.except_counter = 0
        setup(config_path, device)
    return True


def latch_safe_mode(exc: BaseException | None = None) -> None:
    """Degrade to safe mode: decode calls return error code 1 until
    ``initialize()`` re-arms (exc_handler.cpp:214,243)."""
    _STATE.safe_mode = True
    _STATE.except_counter += 1
