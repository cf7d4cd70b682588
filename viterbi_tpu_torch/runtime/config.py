"""Config file system — behavioral twin of the reference's
``%LOCALAPPDATA%\\viterbi\\viterbi.txt`` (setupdll.cpp:57-193,
inifiletext.h:12-31), with the JAX package's format.

  * a self-documenting template is written on first run,
  * the first line's first byte selects the decoder variant ('0'-'4',
    anything else = automatic), the third byte toggles the info banner,
  * the file is re-read on every ``initialize()``,
  * optional ``key=value`` lines follow; unknown keys are ignored.

The port reads its own file (``VITERBI_TPU_TORCH_CONFIG``, or
``viterbi_tpu_torch/viterbi.txt`` under the config home), so the two
packages' tuners never overwrite each other's byte 0.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..ops import _build

CONFIG_ENV = "VITERBI_TPU_TORCH_CONFIG"

_TEMPLATE = """\
a:0
# viterbi_tpu_torch configuration.
#
# Line 1, byte 0: decoder variant override.
#   '0'..'4' force a variant index (see `viterbi_tpu_torch.runtime.dispatch`
#   VARIANTS; downgrades always honored, upgrades only if supported),
#   any other character = automatic selection.
# Line 1, byte 2: '1' prints the chosen variant at initialize().
#
# Optional key=value lines (defaults shown):
# traceback_block=64  (block of the block-parallel traceback, at least 8;
#                      the largest of 64, 48, ..., 1 dividing framebits
#                      where it does not)
# log_calls=0
# log_symbols=0
# compile_cache=1  (the CUDA kernels' build directory, keyed by a hash of
#                   their sources; a path relocates it, 0/1 keep the
#                   default beside the package)
"""


def default_path() -> str:
    override = os.environ.get(CONFIG_ENV)
    if override:
        return override
    base = os.environ.get("XDG_CONFIG_HOME",
                          os.path.join(os.path.expanduser("~"), ".config"))
    return os.path.join(base, "viterbi_tpu_torch", "viterbi.txt")


@dataclass
class Config:
    variant_override: int = -1     # -1 = automatic
    show_info: bool = False
    traceback_block: int = 64
    log_calls: bool = False
    log_symbols: bool = False
    compile_cache: str = field(default_factory=_build.default_build_root)
    path: str = field(default_factory=default_path)


def ensure_config_file(path: str | None = None) -> str:
    path = path or default_path()
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(_TEMPLATE)
    return path


def load(path: str | None = None) -> Config:
    """Read the config file (creating the template on first run)."""
    path = ensure_config_file(path)
    cfg = Config(path=path)
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return cfg
    if lines:
        first = lines[0]
        if len(first) >= 1 and "0" <= first[0] <= "4":
            cfg.variant_override = ord(first[0]) - ord("0")
        if len(first) >= 3 and first[2] == "1":
            cfg.show_info = True
    for line in lines[1:]:
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if key == "traceback_block":
            try:
                cfg.traceback_block = max(8, int(val))
            except ValueError:
                pass
        elif key == "log_calls":
            cfg.log_calls = val not in ("0", "false", "")
        elif key == "log_symbols":
            cfg.log_symbols = val not in ("0", "false", "")
        elif key == "compile_cache":
            # the kernels must be built somewhere: on/off spellings keep
            # the default directory, anything else relocates it
            if val.lower() not in ("", "0", "1", "false", "true", "no",
                                   "yes"):
                cfg.compile_cache = val
    return cfg


def write_variant(index: int, path: str | None = None) -> None:
    """Auto-tuner hook: persist the winning variant into byte 0."""
    path = ensure_config_file(path)
    with open(path) as f:
        content = f.read()
    first_nl = content.find("\n")
    first = content[:first_nl] if first_nl >= 0 else content
    rest = content[first_nl:] if first_nl >= 0 else ""
    ch = str(index) if 0 <= index <= 4 else "a"
    first = ch + (first[1:] if len(first) > 1 else ":0")
    with open(path, "w") as f:
        f.write(first + rest)
