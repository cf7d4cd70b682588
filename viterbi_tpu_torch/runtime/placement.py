"""Where an entry point's input goes, and whether it takes the kernels.

One rule for every entry point of the port (the API's dispatcher, the
DAB chains, tail-biting, streaming, sessions, the pipelined feed, the
tools and the ranks of ``parallel.distributed``): a call runs on the
card unless the caller asks for the CPU, and raises ``NoDeviceError``
where it would need a card and there is none. A tensor stays on its
device unless the caller names another, so a CPU tensor is the caller's
request for the CPU; a host array goes to ``strict_device(device)``.
``use_kernels=None`` then takes the hand-written kernels on a CUDA
tensor and the plain torch path on a CPU tensor; ``use_kernels=True`` on
the CPU is refused, since there the kernels exist only as their plain
versions.

``ingest`` is the one place where a call's input goes to the decode
device (``on_device``, and the API's exports through it); it carries the
``ingest`` span of ``runtime.calllog`` and its counters.

A decode that reads frame-major packed words (kernels A and C and their
plain versions, ``packed="bt"``) takes its symbols through
``ingest_words`` instead. Only a soft symbol's low byte counts, and a
frame's symbols narrowed to bytes are, byte for byte, its packed words
(symbol j of a step in byte j). So a host input of ``STAGE_MIN_BYTES``
or more is narrowed on the host, over torch's intra-op threads, into the
chunks of a fixed ``StagingRing`` (pinned for a card), and each chunk is
copied up on a side stream while the host narrows the next: one byte a
symbol crosses to the card, at the pinned rate, mostly hidden behind the
narrowing. A smaller input, or one already on the device, takes
``ingest``, op for op. ``ingest_bytes`` stages the same way rows that are
not whole trellis steps (punctured symbols, which kernel J depunctures)
and returns them as the bytes they are.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import calllog

_NUMPY = {torch.int32: np.int32, torch.uint8: np.uint8}
#: the dtypes ``ingest_words`` narrows: integers, whose casts to uint8
#: wrap modulo 256, as the direct path's int32 cast and the kernels'
#: low-byte load do together
_NARROWS = frozenset({torch.uint8, torch.int8, torch.int16, torch.int32,
                      torch.int64})
#: input bytes from which ``ingest_words`` narrows and stages: on an H100
#: host the staged upload's median time falls below the direct one's
#: between 1.45 and 1.76 MiB, and is a third lower at 2 MiB (PERF.md)
STAGE_MIN_BYTES = 2 << 20
#: narrowed bytes a chunk of a ``StagingRing``, and its chunks: smaller
#: chunks cost more calls of the narrowing, and more or larger ones gained
#: nothing measurable on 807 MB (PERF.md)
STAGE_CHUNK_BYTES = 16 << 20
STAGE_CHUNKS = 3


class NoDeviceError(RuntimeError):
    """A card was asked for, by name or by default, and there is none."""


def strict_device(device=None) -> torch.device:
    """The device of a call: the current card, unless the caller names
    another (``"cpu"``). Raises ``NoDeviceError`` where a card is asked
    for, by name or by default, and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(f"no CUDA device (no card for {dev}): pass "
                                "device='cpu' (--device cpu) to run on the "
                                "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(symbols, device=None) -> torch.Tensor:
    """Symbols as an int32 tensor on the decode device: a tensor stays
    where it is unless ``device`` names another; a host array goes to
    ``strict_device(device)``."""
    if isinstance(symbols, torch.Tensor) and device is None:
        return ingest(symbols, symbols.device)
    return ingest(symbols, strict_device(device))


def ingest(data, device: torch.device, dtype=torch.int32) -> torch.Tensor:
    """``data`` (a host array or a tensor) as a ``dtype`` tensor on
    ``device``, in the span ``ingest``. Its counters: ``h2d_bytes``, the
    bytes handed over from host memory (0 from a card; on the CPU the
    bytes the decode then reads in place), and ``staged_chunks`` 0."""
    with calllog.span("ingest") as sp:
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.ascontiguousarray(data,
                                                         dtype=_NUMPY[dtype]))
        if sp:
            sp.count(h2d_bytes=data.numel() * dtype.itemsize
                     if data.device.type == "cpu" else 0, staged_chunks=0)
        return data.to(device, dtype)


def on_device_words(symbols, device=None):
    """``on_device`` for a decode that reads frame-major packed words:
    (symbols, layout) as ``ingest_words`` gives them."""
    if isinstance(symbols, torch.Tensor) and device is None:
        return ingest_words(symbols, symbols.device)
    return ingest_words(symbols, strict_device(device))


def ingest_words(data, device: torch.device):
    """``data`` ([..., 4T] soft symbols, a host array or a tensor) on
    ``device`` for a decode that also reads packed words: (symbols,
    layout). A host input of integers of ``STAGE_MIN_BYTES`` or more is
    narrowed to its low bytes through the device's ``StagingRing`` and
    comes back as int32[..., T] frame-major packed words, a view of the
    uint8 device buffer, with the layout ``"bt"``; anything else as
    ``ingest`` gives it, with the layout False. The ``ingest`` span
    counts ``h2d_bytes`` (one a symbol when staged) and
    ``staged_chunks`` (0 on the direct path)."""
    src = _host_integers(data, device)
    if src is None or src.shape[-1] % 4:
        return ingest(data, device), False
    return _stage(src, device).view(torch.int32), "bt"


def on_device_bytes(symbols, device=None) -> torch.Tensor:
    """``on_device`` for a decode that reads each symbol's low byte
    (kernel J): the symbols as ``ingest_bytes`` gives them."""
    if isinstance(symbols, torch.Tensor) and device is None:
        return ingest_bytes(symbols, symbols.device)
    return ingest_bytes(symbols, strict_device(device))


def ingest_bytes(data, device: torch.device) -> torch.Tensor:
    """``data`` ([..., W] soft symbols, a host array or a tensor, W any
    width) on ``device`` for a decode that reads each symbol's low byte:
    a host input of integers of ``STAGE_MIN_BYTES`` or more narrowed
    through the device's ``StagingRing`` into uint8[..., W]; anything
    else as ``ingest`` gives it, int32. The ``ingest`` span counts as in
    ``ingest_words``."""
    src = _host_integers(data, device)
    if src is None:
        return ingest(data, device)
    return _stage(src, device)


def _stage(src: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The host integers ``src`` narrowed to a uint8 tensor of its shape
    on ``device`` through the device's ``StagingRing``, in the span
    ``ingest``."""
    with calllog.span("ingest") as sp:
        dst = torch.empty(src.numel(), dtype=torch.uint8, device=device)
        chunks = staging_ring(device).upload(src.reshape(-1, src.shape[-1]),
                                             dst)
        if sp:
            sp.count(h2d_bytes=dst.numel(), staged_chunks=chunks)
        return dst.view(src.shape)


def _host_integers(data, device: torch.device, min_bytes: int | None = None):
    """``data`` as a CPU tensor that ``ingest_words`` and ``ingest_bytes``
    narrow (host integers of a ``_NARROWS`` dtype, ``min_bytes`` or more,
    by default ``STAGE_MIN_BYTES``, not already on ``device``); None where
    it takes the direct path. The one-frame plans (``runtime.frameplan``)
    narrow by the same rule with no floor."""
    if min_bytes is None:
        min_bytes = STAGE_MIN_BYTES
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
        if data.nbytes < min_bytes:
            return None
        # torch takes integers in native byte order, with strides of
        # whole elements
        if data.dtype.kind not in "iu" or not data.dtype.isnative or any(
                s < 0 or s % data.itemsize for s in data.strides):
            return None
        if data.dtype.kind == "u" and data.itemsize > 1:
            # the same bytes as signed integers: the low byte is the same
            data = data.view(f"i{data.itemsize}")
        data = torch.from_numpy(data)
    elif (data.device.type != "cpu" or data.device == device
          or data.numel() * data.element_size() < min_bytes):
        return None
    if data.dtype not in _NARROWS or data.dim() == 0:
        return None
    return data


class StagingRing:
    """A fixed ring of host chunks through which ``ingest_words`` sends
    narrowed symbols to one device: pinned for a card, whose copies run
    on the ring's own stream. Its size does not follow the call's. One
    upload holds the ring's lock, so two threads never write one chunk,
    and a chunk is written only after the event of its last copy."""

    def __init__(self, device, chunks: int = STAGE_CHUNKS,
                 chunk_bytes: int = STAGE_CHUNK_BYTES):
        self.device = torch.device(device)
        card = self.device.type == "cuda"
        self.chunks = [torch.empty(chunk_bytes, dtype=torch.uint8,
                                   pin_memory=card)
                       for _ in range(chunks)]
        self.copied = [None] * chunks     # each chunk's last copy's event
        self.stream = torch.cuda.Stream(self.device) if card else None
        self._next = 0
        self._lock = threading.Lock()

    def upload(self, src: torch.Tensor, dst: torch.Tensor) -> int:
        """Narrow ``src`` (a 2-D CPU tensor of integers, any strides),
        row by row, to its low bytes into the uint8[src.numel()] ``dst``
        on the ring's device, one chunk at a time; returns the chunks.
        On a card the current stream waits for the last copy; ``dst``
        was made on it, so the copies first wait for its earlier work."""
        total, size = src.numel(), self.chunks[0].numel()
        done = None
        with self._lock:
            if self.stream is not None:
                compute = torch.cuda.current_stream(self.device)
                self.stream.wait_stream(compute)
            for a in range(0, total, size):
                b = min(a + size, total)
                k = self._next
                self._next = (k + 1) % len(self.chunks)
                if self.copied[k] is not None:
                    self.copied[k].synchronize()
                buf = self.chunks[k][: b - a]
                narrow_rows(src, a, b, buf)
                if self.stream is None:
                    dst[a:b].copy_(buf)
                    continue
                with torch.cuda.stream(self.stream):
                    dst[a:b].copy_(buf, non_blocking=True)
                    done = self.copied[k] = torch.cuda.Event()
                    done.record(self.stream)
            if done is not None:
                compute.wait_event(done)
        return -(-total // size)


def narrow_rows(src: torch.Tensor, a: int, b: int,
                out: torch.Tensor) -> None:
    """Elements [a, b) of the row-major 2-D ``src``, each cast to its low
    byte (a wrapping cast), into the uint8[b - a] ``out``: a partial first
    row, the whole rows, a partial last row, each one torch copy (over
    the intra-op threads where it is large)."""
    width = src.shape[1]
    (r0, c0), (r1, c1) = divmod(a, width), divmod(b, width)
    if r0 == r1:
        out.copy_(src[r0, c0:c1])
        return
    pos = 0
    if c0:
        pos = width - c0
        out[:pos].copy_(src[r0, c0:])
        r0 += 1
    if r1 > r0:
        n = (r1 - r0) * width
        out[pos:pos + n].view(r1 - r0, width).copy_(src[r0:r1])
        pos += n
    if c1:
        out[pos:].copy_(src[r1, :c1])


_rings: dict = {}
_rings_lock = threading.Lock()


def staging_ring(device: torch.device) -> StagingRing:
    """The device's ``StagingRing``, made at its first use."""
    with _rings_lock:
        ring = _rings.get(device)
        if ring is None:
            ring = _rings[device] = StagingRing(device)
        return ring


def want_kernels(use_kernels: bool | None, device: torch.device) -> bool:
    """Whether a call on ``device`` runs the kernels: by default where the
    device is a card; ``True`` on another device raises."""
    on_card = torch.device(device).type == "cuda"
    if use_kernels and not on_card:
        raise ValueError("use_kernels=True needs symbols on a CUDA device, "
                         f"got {device}")
    return on_card if use_kernels is None else bool(use_kernels)
