"""Host-to-device feed: keep the card decoding while the host stages the
next batch (SURVEY.md §7.3 "Host ingestion"). The port of
``viterbi_tpu.utils.pipeline``.

A pageable host-to-device copy is most of every API call (PERF.md §5):
CUDA stages it through a pinned buffer of its own, one chunk at a time,
and the host waits for it. Here ``depth`` pinned staging buffers take
turns: the host copies batch n+1 into a free one (torch's copy, on all
its host threads) while the card decodes batch n, the copy to the card
runs on a side stream, and the decode waits for it on the current stream
through an event:

    host: stage n+1 | side stream: copy n+1 to the card | current: decode n

Each result goes back to a pinned host tensor without blocking; results
are yielded oldest first, so the host waits only when the card is behind.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..runtime.placement import strict_device


def _to_host(out: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event]:
    """Start the copy of a result to a pinned host tensor on the current
    stream; the event says when it has landed."""
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def decode_pipelined(batches: Iterable[np.ndarray], decode_fn: Callable,
                     depth: int = 2, device=None) -> Iterator[np.ndarray]:
    """Stream host batches through ``decode_fn`` with ``depth`` batches in
    flight.

    ``batches``: host arrays (any shape and dtype ``decode_fn`` takes).
    ``decode_fn``: a function of one tensor on ``device`` (the card unless
    the caller names another; ``placement.NoDeviceError`` without one)
    that returns one tensor. Yields each result as a numpy
    array, in the order of the batches. On the CPU the same order runs
    with no streams and no staging.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dev = strict_device(device)
    it = iter(batches)
    if dev.type != "cuda":
        inflight: collections.deque = collections.deque()
        for host in it:
            inflight.append(decode_fn(
                torch.from_numpy(np.ascontiguousarray(host)).to(dev)))
            if len(inflight) == depth:
                yield inflight.popleft().numpy()
        while inflight:
            yield inflight.popleft().numpy()
        return

    copy_stream = torch.cuda.Stream(dev)
    compute = torch.cuda.current_stream(dev)
    staging: list = [None] * depth         # pinned buffers, by slot
    copied: list = [None] * depth          # events: slot's copy finished
    results: collections.deque = collections.deque()
    for n, host in enumerate(it):
        slot = n % depth
        src = torch.from_numpy(np.ascontiguousarray(host))
        buf = staging[slot]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            # torch's pinned allocator keeps freed buffers, so a later
            # feed of the same shapes pins no memory again
            buf = staging[slot] = torch.empty(src.shape, dtype=src.dtype,
                                              pin_memory=True)
        else:
            copied[slot].synchronize()     # its last copy has left it
        buf.copy_(src)                     # on torch's host threads
        with torch.cuda.stream(copy_stream):
            dev_batch = buf.to(dev, non_blocking=True)
            copied[slot] = torch.cuda.Event()
            copied[slot].record()
        compute.wait_event(copied[slot])
        # the batch was made on the side stream and is used on this one
        dev_batch.record_stream(compute)
        results.append(_to_host(decode_fn(dev_batch)))
        if len(results) == depth:
            out, done = results.popleft()
            done.synchronize()
            yield out.numpy()
    while results:
        out, done = results.popleft()
        done.synchronize()
        yield out.numpy()
