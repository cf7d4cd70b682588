"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Two shared libraries with a plain C interface (no PyTorch headers, so a
build takes seconds): the decode kernels from ``csrc/*.cu`` (``MAIN``),
built when the dispatcher first probes a card, and the timing probes from
``csrc/probes/*.cu`` (``PROBES``), built when a probe is first used, so
the decode path never pays for them. ``nvcc`` compiles every source of a
library for Hopper (``sm_90a``) at the same time, one process each, and
links the objects. A library lands in a directory keyed by a hash of its
sources, the shared headers (``csrc/*.cuh``) and the flags under the
build root (``build/kernels`` beside the package by default; the config
key ``compile_cache`` moves it), so a changed source never loads a stale
library and an unchanged one is built once. Each C entry point launches
on the caller's stream and returns ``cudaGetLastError()``; ``check``
turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    """One shared library: its file name and where its sources lie."""
    file_name: str
    src_dir: Path

    def sources(self) -> list[Path]:
        return sorted(self.src_dir.glob("*.cu"))

    def source_key(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in [*sorted(CSRC.glob("*.cuh")), *self.sources()]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return h.hexdigest()[:16]


MAIN = Library("libviterbi_tpu_torch.so", CSRC)
PROBES = Library("libviterbi_tpu_torch_probes.so", CSRC / "probes")

_lock = threading.Lock()
_libs: dict[Library, ctypes.CDLL] = {}


def default_build_root() -> str:
    return str(Path(__file__).resolve().parents[2] / "build" / "kernels")


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    return fallback if os.path.exists(fallback) else None


def build(root: str | None = None, library: Library = MAIN) -> Path:
    """Compile a library unless this source hash is already built;
    returns the library path. The compiler's output, ``-Xptxas -v``
    register and spill counts included, is kept in ``build.log``."""
    out_dir = Path(root or default_build_root()) / library.source_key()
    lib_path = out_dir / library.file_name
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [out_dir / f"{src.stem}.{tag}.o" for src in library.sources()]
    # one compiler per source, all started together
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(library.sources(), objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (code {proc.returncode}):\n"
                          f"{out[-4000:]}")
    tmp = out_dir / f"{library.file_name}.{tag}"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (code {proc.returncode}):\n"
                          f"{proc.stderr[-4000:]}")
    (out_dir / "build.log").write_text("".join(log))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    os.replace(tmp, lib_path)   # atomic: concurrent builds never tear
    return lib_path


def build_log(root: str | None = None, library: Library = MAIN) -> str:
    """The compiler's output of the build that ``build`` made or found."""
    out_dir = Path(root or default_build_root()) / library.source_key()
    return (out_dir / "build.log").read_text()


def _bind(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.acs_regs_launch.argtypes = [P, L, L, I, P, I, I, I, I, I, P, P,
                                    I, I, I, P]
    lib.acs_regs_launch.restype = I
    lib.tb_walk_launch.argtypes = [P, P, P, I, I, I, I, P, I, I, P]
    lib.tb_walk_launch.restype = I
    lib.acs_words_launch.argtypes = [P, L, L, I, P, I, I, P, P, I, I, I, P]
    lib.acs_words_launch.restype = I
    lib.tb_words_launch.argtypes = [P, I, I, P, I, I, P]
    lib.tb_words_launch.restype = I
    lib.vt_error_string.argtypes = [I]
    lib.vt_error_string.restype = ctypes.c_char_p


def _bind_probes(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kablate_launch.argtypes = [P, L, L, I, P, I, I, I, P, P, I, I, I, P]
    lib.kablate_launch.restype = I
    lib.kdtype_op_launch.argtypes = [I, I, P, P, P, I, I, P]
    lib.kdtype_op_launch.restype = I
    lib.kdtype_chain_launch.argtypes = [I, P, P, I, I, I, I, I, I, P]
    lib.kdtype_chain_launch.restype = I
    lib.kilp_streams_launch.argtypes = [I, I, P, P, I, I, I, I, P]
    lib.kilp_streams_launch.restype = I
    lib.vt_error_string.argtypes = [I]
    lib.vt_error_string.restype = ctypes.c_char_p


_BINDERS = {MAIN: _bind, PROBES: _bind_probes}


def load(root: str | None = None, library: Library = MAIN) -> ctypes.CDLL:
    """A loaded kernel library, built on first use."""
    with _lock:
        if library not in _libs:
            lib = ctypes.CDLL(str(build(root, library)))
            _BINDERS[library](lib)
            _libs[library] = lib
        return _libs[library]


def stream_arg(device) -> ctypes.c_void_p:
    """The caller's current CUDA stream on ``device`` as a C argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err:
        msg = lib.vt_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {err})")
