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

import contextlib
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


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# every entry point's arguments; each takes the stream as its last one
_ARGTYPES = {
    MAIN: {
        "acs_regs_launch": [_P, _L, _L, _I, _P, _I, _I, _I, _I, _I, _P, _P,
                            _I, _I, _P],
        "tb_walk_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I,
                           _I, _P],
        "acs_words_launch": [_P, _L, _L, _I, _P, _I, _I, _P, _P, _I, _I, _P],
        "tb_words_launch": [_P, _I, _I, _P, _I, _P],
        "rs_decode_launch": [_P, _I, _I, _I, _L, _L, _L, _P, _P, _P, _P,
                             _I, _P],
        "rs_superframes_launch": [_P, _L, _I, _I, _I, _P, _P, _P, _P, _P,
                                  _I, _P],
        "depuncture_launch": [_P, _L, _I, _P, _I, _I, _P, _I, _P],
        "rs_packets_launch": [_P, _L, _I, _P, _P, _P, _P, _I, _P],
        "deinterleave_launch": [_P, _L, _L, _I, _P, _P, _P, _I, _P],
    },
    PROBES: {
        "kablate_launch": [_P, _L, _L, _I, _P, _I, _I, _I, _P, _P, _I, _I,
                           _P],
        "kdtype_op_launch": [_I, _I, _P, _P, _P, _I, _P],
        "kdtype_chain_launch": [_I, _P, _P, _I, _I, _I, _I, _I, _P],
        "kilp_streams_launch": [_I, _I, _P, _P, _I, _I, _I, _P],
        "rs_table_decode_launch": [_P, _I, _I, _I, _L, _L, _L, _P, _P, _P,
                                   _P, _I, _P],
        "rs_table_superframes_launch": [_P, _L, _I, _I, _I, _P, _P, _P, _P,
                                        _P, _I, _P],
        "rs_phases_launch": [_P, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                             _P],
    },
}


def _bind(lib: ctypes.CDLL, library: Library = MAIN) -> None:
    for symbol, argtypes in _ARGTYPES[library].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.vt_error_string.argtypes = [_I]
    lib.vt_error_string.restype = ctypes.c_char_p


def load(root: str | None = None, library: Library = MAIN) -> ctypes.CDLL:
    """A loaded kernel library, built on first use."""
    with _lock:
        if library not in _libs:
            lib = ctypes.CDLL(str(build(root, library)))
            _bind(lib, library)
            _libs[library] = lib
        return _libs[library]


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err:
        msg = lib.vt_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {err})")


# The caller's current stream and device as plain integers: what torch's
# own Triton launcher reads. The public calls build a Stream object each.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
_current_device = getattr(torch._C, "_cuda_getDevice", None) \
    or torch.cuda.current_device


class Kernel:
    """One C entry point: the launch path that every wrapper shares.

    The library is loaded (and built) and the function looked up at the
    first launch; from then on a launch is one ctypes call. The function
    launches on the caller's current stream of the tensors' device, which
    is made the current device only where it is not, and returns
    ``cudaGetLastError()``: a refused launch raises.

    The launch path is where launches are counted: each launch the card
    accepts adds one to ``tally``, under the form the wrapper names
    (kernel A's lanes a frame; None for a kernel of one form), or, while
    its thread captures a CUDA graph, to the launches ``recording``
    hands back. ``launches`` is their sum; ``ops.counts`` reads them.
    """

    __slots__ = ("library", "symbol", "name", "tally", "_lib", "_fn")

    def __init__(self, library: Library, symbol: str, name: str,
                 forms: tuple = (None,)):
        assert symbol in _ARGTYPES[library], symbol
        self.library, self.symbol, self.name = library, symbol, name
        self.tally = dict.fromkeys(forms, 0)
        self._lib = self._fn = None

    @property
    def launches(self) -> int:
        return sum(self.tally.values())

    def zero(self) -> None:
        for form in self.tally:
            self.tally[form] = 0

    def function(self):
        """The bound C function (loads the library at first use)."""
        if self._fn is None:
            self._lib = load(library=self.library)
            self._fn = getattr(self._lib, self.symbol)
        return self._fn

    def launch(self, device: torch.device, *args, form=None) -> None:
        """Launch on ``device`` (a CUDA device with its index, as a
        tensor's) with the C function's arguments but the stream, and
        count it under ``form``."""
        fn = self._fn or self.function()
        index = device.index
        if index == _current_device():
            err = fn(*args, _raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, _raw_stream(index))
        if err:
            check(self._lib, err, self.name)
        made = _capturing.made
        if made is None:
            self.tally[form] += 1
        else:
            made[self, form] = made.get((self, form), 0) + 1


class _Capturing(threading.local):
    #: the launches of the graph this thread captures; None outside one
    made = None


_capturing = _Capturing()


@contextlib.contextmanager
def recording():
    """Inside the block, this thread's launches are counted into the dict
    it hands back, by (``Kernel``, form), and not into the tallies: a CUDA
    graph's capture launches nothing on the card. Each replay of the
    graph then adds them (``replayed``)."""
    _capturing.made = made = {}
    try:
        yield made
    finally:
        _capturing.made = None


def replayed(made: dict) -> None:
    """Adds the launches of one replay of a captured graph, as
    ``recording`` handed them back, to the kernels' tallies."""
    for (kernel, form), n in made.items():
        kernel.tally[form] += n


#: kernel A counts its launches by form: 1, 4 (kLanes) or 32 (kWarpLanes)
#: lanes a frame, as ``acs_cuda`` names them
ACS_REGS = Kernel(MAIN, "acs_regs_launch", "acs_regs", forms=(1, 4, 32))
TB_WALK = Kernel(MAIN, "tb_walk_launch", "tb_walk")
ACS_WORDS = Kernel(MAIN, "acs_words_launch", "acs_words")
TB_WORDS = Kernel(MAIN, "tb_words_launch", "tb_words")
RS_DECODE = Kernel(MAIN, "rs_decode_launch", "rs_decode")
RS_SUPERFRAMES = Kernel(MAIN, "rs_superframes_launch", "rs_superframes")
DEPUNCTURE = Kernel(MAIN, "depuncture_launch", "depuncture")
RS_PACKETS = Kernel(MAIN, "rs_packets_launch", "rs_packets")
DEINTERLEAVE = Kernel(MAIN, "deinterleave_launch", "deinterleave")
KABLATE = Kernel(PROBES, "kablate_launch", "kablate")
KDTYPE_OP = Kernel(PROBES, "kdtype_op_launch", "kdtype_op")
KDTYPE_CHAIN = Kernel(PROBES, "kdtype_chain_launch", "kdtype_chain")
KILP_STREAMS = Kernel(PROBES, "kilp_streams_launch", "kilp_streams")
RS_TABLE_DECODE = Kernel(PROBES, "rs_table_decode_launch", "rs_table_decode")
RS_TABLE_SUPERFRAMES = Kernel(PROBES, "rs_table_superframes_launch",
                              "rs_table_superframes")
RS_PHASES = Kernel(PROBES, "rs_phases_launch", "rs_phases")
