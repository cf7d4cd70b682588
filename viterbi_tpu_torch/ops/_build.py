"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface: no PyTorch headers, so
a build takes seconds. The library lands in a directory keyed by a hash
of the sources, their shared header (``csrc/*.cuh``) and the flags under
the build root (``build/kernels`` beside the package by default; the
config key ``compile_cache`` moves it), so a changed source never loads a
stale library and an unchanged one is built once. Each C entry point
launches on the caller's stream and returns ``cudaGetLastError()``;
``check`` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
LIB_NAME = "libviterbi_tpu_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def default_build_root() -> str:
    return str(Path(__file__).resolve().parents[2] / "build" / "kernels")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):    # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    return fallback if os.path.exists(fallback) else None


def build(root: str | None = None) -> Path:
    """Compile the kernels unless this source hash is already built;
    returns the library path. The compiler's output, ``-Xptxas -v``
    register and spill counts included, is kept in ``build.log``."""
    out_dir = Path(root or default_build_root()) / source_key()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)   # atomic: concurrent builds never tear
    return lib_path


def _bind(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.acs_regs_launch.argtypes = [P, L, L, I, P, I, I, I, I, I, P, P,
                                    I, I, P]
    lib.acs_regs_launch.restype = I
    lib.tb_walk_launch.argtypes = [P, P, P, I, I, I, I, P, I, I, P]
    lib.tb_walk_launch.restype = I
    lib.acs_words_launch.argtypes = [P, L, L, I, P, I, I, P, P, I, I, P]
    lib.acs_words_launch.restype = I
    lib.tb_words_launch.argtypes = [P, I, I, P, I, I, P]
    lib.tb_words_launch.restype = I
    lib.vt_error_string.argtypes = [I]
    lib.vt_error_string.restype = ctypes.c_char_p


def load(root: str | None = None) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(root)))
            _bind(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err:
        msg = lib.vt_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {err})")
