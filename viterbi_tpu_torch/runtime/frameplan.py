"""One-frame plans: the export ``deconvolve`` as one replayed CUDA graph a
frame size.

A one-frame ``deconvolve`` on the card asks the card for about 0.1 ms
(kernels A and B and two small copies) and the host for three times that:
the wrappers' Python, their allocations, the pageable copy, the readback.
A ``FramePlan`` holds what a call of one size needs at fixed addresses, a
pinned host input of one byte a symbol, its device twin, the initial
metrics and a pinned host output, and one CUDA graph of the copy up,
kernel A on the frame-major packed words (``packed="bt"``, its warp-wide
form at one frame), kernel B with the byte assembly (``tb_walk_bytes``)
and the copy back. A call narrows the caller's symbols to their low bytes
into the pinned input (the wrapping cast of ``placement.narrow_rows``),
replays the graph, waits for the replay's event and copies the bytes out
into a fresh array, so that no result the caller keeps aliases the pinned
output.

Which calls take a plan follows the input alone (``takes``): the decode
device a card, the rung ``cuda_fused``, framebits on the byte grid, the
symbols host integers (``placement._host_integers`` with no floor).
Every other call keeps the eager path. A size's first call runs eagerly
as its warm-up and its second captures the plan on a side stream, so a
size called once never pays for a capture; replays run on the caller's
stream. ``PlanCache`` keeps at most ``PLANS`` sizes, dropping the least
recently used; the API's ``initialize()`` drops them all. A plan serves
one caller at a time: a thread that finds its size's plan busy takes the
eager path.

Launches are counted as on the eager path: the capture's launches are
recorded, not tallied (``_build.recording``), and each replay adds them
(``_build.replayed``), so ``ops.counts`` and the ``viterbi`` stage read
two launches a call, kernel A in its warp-wide form. The spans are the
eager path's: ``ingest`` (the narrowing; ``h2d_bytes`` one a symbol),
``viterbi`` (the replay) and ``readback`` (the wait and the copy out).
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from .. import constants as C
from ..ops import _build, acs, acs_cuda, counts
from . import calllog, dispatch, placement

#: sizes a ``PlanCache`` keeps: the DAB+ ladder's 7 and 3072 bits, twice
PLANS = 16
FUSED = dispatch.VARIANTS.index("cuda_fused")


def takes(st, symbols, framebits: int):
    """``symbols`` as the CPU tensor of integers a plan narrows, where a
    call of ``framebits`` on the dispatcher ``st`` takes one; None where
    it keeps the eager path."""
    if st.device.type != "cuda" or st.variant != FUSED or framebits % 8:
        return None
    return placement._host_integers(symbols, st.device, min_bytes=0)


class FramePlan:
    """The buffers and the CUDA graph of one frame size on one device.
    ``lock`` is held by the one caller a plan serves at a time."""

    def __init__(self, device: torch.device, framebits: int):
        card = device.type == "cuda"
        self.device, self.framebits = device, framebits
        nsteps = framebits + C.TAIL_BITS
        self.host_in = torch.empty(C.RATE * nsteps, dtype=torch.uint8,
                                   pin_memory=card)
        self.host_out = torch.empty(framebits // 8, dtype=torch.uint8,
                                    pin_memory=card)
        self.out = self.host_out.numpy()
        self.dev_in = torch.empty_like(self.host_in, device=device)
        self.metrics = acs.init_metrics(1, device)
        self.graph = self.done = None
        self.made: dict = {}     # one replay's launches, by (Kernel, form)
        self.captures = self.replays = 0
        self.lock = threading.Lock()

    def run(self, src: torch.Tensor) -> np.ndarray:
        """Decodes the frame ``src`` (its 4 * (framebits + 6) host
        integers): the narrowing, the replay (captured first at the plan's
        first run) and the copy out, in the eager path's spans."""
        with calllog.span("ingest") as sp:
            self.host_in.copy_(src)
            if sp:
                sp.count(h2d_bytes=self.host_in.numel(), staged_chunks=0)
        with counts.stage("viterbi"):
            if self.graph is None:
                self._capture()
                self.captures += 1
            self._replay()
            _build.replayed(self.made)
            self.replays += 1
        with calllog.span("readback") as sp:
            if sp:
                sp.count(d2h_bytes=self.out.size)
            self.done.synchronize()
            return self.out.copy()

    def _capture(self) -> None:
        """Records the graph on a side stream of its own (a capture runs
        nothing on the card) and the launches it makes."""
        nsteps = self.framebits + C.TAIL_BITS
        words = self.dev_in.view(torch.int32).view(1, nsteps)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(side), _build.recording() as made:
            # this thread's capture only: other callers keep the card
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.dev_in.copy_(self.host_in, non_blocking=True)
                out = acs_cuda.decode(words, self.framebits, packed="bt",
                                      initial_metrics=self.metrics)
                self.host_out.copy_(out[0], non_blocking=True)
            finally:
                graph.capture_end()
        self.graph, self.made = graph, made
        self.done = torch.cuda.Event()

    def _replay(self) -> None:
        """Replays the graph on the caller's stream, behind the metrics'
        fill, and records ``done`` after it: entering a stream of the
        plan's own took 16 us a call on an H100's host (PERF.md), more
        than the graph's copies."""
        self.graph.replay()
        self.done.record(torch.cuda.current_stream(self.device))


class PlanCache:
    """The plans of at most ``bound`` (device, framebits) keys, the least
    recently used dropped first. A key seen once holds None: its call ran
    eagerly, and the next makes the plan."""

    def __init__(self, bound: int = PLANS, make=FramePlan):
        self.bound, self.make = bound, make
        self._plans: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def plan(self, device: torch.device, framebits: int):
        """The plan of ``framebits`` on ``device``, made at the key's
        second sight; None at its first."""
        key = (device, framebits)
        with self._lock:
            plan = self._plans.get(key)
            if key in self._plans:
                self._plans.move_to_end(key)
                if plan is None:
                    plan = self._plans[key] = self.make(device, framebits)
            else:
                self._plans[key] = None
                while len(self._plans) > self.bound:
                    self._plans.popitem(last=False)
            return plan

    def decode(self, st, symbols, framebits: int) -> np.ndarray | None:
        """The call's decoded bytes through its plan, or None where it
        takes the eager path: another call's input (``takes``), the size's
        first sight, or its plan busy with another thread's call."""
        src = takes(st, symbols, framebits)
        if src is None:
            return None
        plan = self.plan(st.device, framebits)
        if plan is None or not plan.lock.acquire(blocking=False):
            return None
        try:
            return plan.run(src)
        finally:
            plan.lock.release()

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()

    def stats(self) -> dict:
        """The plans held, and their captures and replays."""
        with self._lock:
            plans = [p for p in self._plans.values() if p is not None]
        return {"plans": len(plans),
                "captures": sum(p.captures for p in plans),
                "replays": sum(p.replays for p in plans)}


#: the API's plans
CACHE = PlanCache()
