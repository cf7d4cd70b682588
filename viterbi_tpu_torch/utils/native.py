"""ctypes bindings for the native host runtime ``native/vitio.cpp``: the
port's copy of ``viterbi_tpu.utils.native``.

The library is compiled from its source at first use with the flags of
``native/Makefile`` into ``build/native/<hash of source and flags>/``
beside the package (the repository's ``native/`` is never written), so a
changed source never loads a stale library. Every entry point has a
numpy fall-back (``*_plain``, ``FrameRing`` in Python) for hosts without
a C++ compiler; ``have_native()`` says which is active.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import golden

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "vitio.cpp"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")   # Makefile's

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return ROOT / "build" / "native" / h.hexdigest()[:16] / "libvitio.so"


def build() -> Path:
    """Compile ``libvitio.so`` unless this source hash is built already;
    returns its path. Raises when no compiler is found or it fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler found for native/vitio.cpp")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE),
         "-lpthread"], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building native/vitio.cpp failed "
                           f"(code {proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)   # atomic: concurrent builds never tear
    return path


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.vit_encode.argtypes = [u8p, ctypes.c_int, u8p]
    lib.vit_pack_bits.argtypes = [u8p, ctypes.c_int, u8p]
    lib.vit_unpack_bits.argtypes = [u8p, ctypes.c_int, u8p]
    lib.vit_rs_deinterleave.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                        u8p]
    lib.vit_rs_interleave.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.vit_depuncture.argtypes = [u32p, ctypes.c_int, u8p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_uint32, u32p]
    lib.vit_depuncture.restype = ctypes.c_int
    lib.vit_ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.vit_ring_create.restype = ctypes.c_void_p
    lib.vit_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.vit_ring_close.argtypes = [ctypes.c_void_p]
    lib.vit_ring_push.argtypes = [ctypes.c_void_p, u32p, ctypes.c_int64]
    lib.vit_ring_push.restype = ctypes.c_int
    lib.vit_ring_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, u32p, i64p]
    lib.vit_ring_pop_batch.restype = ctypes.c_int
    lib.vit_ring_size.argtypes = [ctypes.c_void_p]
    lib.vit_ring_size.restype = ctypes.c_int


def _load():
    """The bound library, built at the first call; None where it cannot
    be built or loaded (the numpy fall-backs then run)."""
    global _lib, _build_attempted
    with _lib_lock:
        if _lib is not None or _build_attempted:
            return _lib
        _build_attempted = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        _bind(lib)
        _lib = lib
        return _lib


def have_native() -> bool:
    return _load() is not None


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def encode_plain(bits: np.ndarray) -> np.ndarray:
    return golden.encode(bits)


def encode(bits: np.ndarray) -> np.ndarray:
    """Native twin of golden.encode (hard symbols incl. 6 flush bits)."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return encode_plain(bits)
    out = np.empty(4 * (bits.size + 6), dtype=np.uint8)
    lib.vit_encode(_u8(bits), bits.size, _u8(out))
    return out


def pack_bits_plain(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.ascontiguousarray(bits, dtype=np.uint8))


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """MSB-first packing of 0/1 bits (``np.packbits``)."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return pack_bits_plain(bits)
    out = np.empty((bits.size + 7) // 8, dtype=np.uint8)
    lib.vit_pack_bits(_u8(bits), bits.size, _u8(out))
    return out


def depuncture_plain(symbols: np.ndarray, mask: np.ndarray, n_out: int,
                     fill: int = 127) -> np.ndarray:
    symbols = np.ascontiguousarray(symbols, dtype=np.uint32)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.full(n_out, fill, dtype=np.uint32)
    tiled = np.tile(mask, -(-n_out // mask.size))[:n_out].astype(bool)
    k = min(int(tiled.sum()), symbols.size)
    idx = np.flatnonzero(tiled)[:k]
    out[idx] = symbols[:k]
    return out


def depuncture(symbols: np.ndarray, mask: np.ndarray, n_out: int,
               fill: int = 127) -> np.ndarray:
    """Expand punctured soft symbols to the full rate-1/4 stream."""
    symbols = np.ascontiguousarray(symbols, dtype=np.uint32)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return depuncture_plain(symbols, mask, n_out, fill)
    out = np.empty(n_out, dtype=np.uint32)
    lib.vit_depuncture(_u32(symbols), symbols.size, _u8(mask), mask.size,
                       n_out, fill, _u32(out))
    return out


def rs_deinterleave_plain(p: np.ndarray, rs_dims: int,
                          word_len: int = 120) -> np.ndarray:
    p = np.ascontiguousarray(p, dtype=np.uint8)
    return p[: rs_dims * word_len].reshape(word_len, rs_dims).T.copy()


def rs_deinterleave(p: np.ndarray, rs_dims: int, word_len: int = 120):
    """Superframe bytes p[j + k*rs_dims] -> codewords uint8[rs_dims,
    word_len]."""
    p = np.ascontiguousarray(p, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return rs_deinterleave_plain(p, rs_dims, word_len)
    out = np.empty((rs_dims, word_len), dtype=np.uint8)
    lib.vit_rs_deinterleave(_u8(p), rs_dims, word_len, _u8(out))
    return out


class FrameRing:
    """Thread-safe frame ring: producers push frames, a consumer pops
    fixed-size batches for device dispatch (native when available, else
    a deque under a condition variable)."""

    def __init__(self, capacity: int, frame_len: int):
        self.frame_len = frame_len
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.vit_ring_create(capacity, frame_len)
        else:
            self._q = collections.deque()
            self._cap = capacity
            self._cv = threading.Condition()
            self._closed = False

    def push(self, frame: np.ndarray, tag: int = 0) -> bool:
        frame = np.ascontiguousarray(frame, dtype=np.uint32)
        if frame.size != self.frame_len:
            raise ValueError(f"frame of {frame.size} words, the ring "
                             f"holds {self.frame_len}")
        if self._lib is not None:
            return self._lib.vit_ring_push(self._h, _u32(frame), tag) == 0
        with self._cv:
            while len(self._q) >= self._cap and not self._closed:
                self._cv.wait()
            if self._closed:
                return False
            self._q.append((frame.copy(), tag))
            self._cv.notify_all()
            return True

    def pop_batch(self, batch: int, min_batch: int = 1):
        if self._lib is not None:
            out = np.empty((batch, self.frame_len), dtype=np.uint32)
            tags = np.empty(batch, dtype=np.int64)
            n = self._lib.vit_ring_pop_batch(
                self._h, batch, min_batch, _u32(out),
                tags.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            return out[:n], tags[:n]
        with self._cv:
            while len(self._q) < min_batch and not self._closed:
                self._cv.wait()
            n = min(batch, len(self._q))
            items = [self._q.popleft() for _ in range(n)]
            self._cv.notify_all()
        if not items:
            return (np.empty((0, self.frame_len), np.uint32),
                    np.empty(0, np.int64))
        frames, tags = zip(*items)
        return np.stack(frames), np.asarray(tags, dtype=np.int64)

    def close(self):
        if self._lib is not None:
            self._lib.vit_ring_close(self._h)
        else:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._lib.vit_ring_destroy(self._h)
