"""Ranks for the port's several-process tests: threads of one process over
one ``HashStore`` (``thread_ranks``), and the functions that ranks
spawned as processes run (they must import by path, so they live here
and import nothing of JAX)."""

from __future__ import annotations

import datetime
import os
import threading
import time

import torch
import torch.distributed as dist

from viterbi_tpu_torch.parallel import mesh as M

# every group of a test waits at most this long for a peer
TIMEOUT = datetime.timedelta(seconds=30)
JOIN_S = 120.0      # and every thread rank is joined within this


def _waiting(fn, turn: threading.Lock):
    """``fn`` with the rank's turn handed on while it waits for peers."""
    def wait(*args, **kwargs):
        turn.release()
        try:
            return fn(*args, **kwargs)
        finally:
            turn.acquire()
    return wait


def thread_ranks(fn, world_size: int, timeout: float = JOIN_S) -> list:
    """``fn(rank, world_size, store)`` in ``world_size`` threads over one
    ``HashStore``; their results in rank order. Every thread is joined
    with a timeout and a thread still running fails the test; a rank's
    exception is raised here.

    The ranks take turns: one computes at a time and hands its turn on
    while it waits in a mesh's set-up, an exchange or a gather. Threads
    that all ran torch's many small calls at once would spend most of
    their time handing the interpreter lock to each other."""
    store = dist.HashStore()
    results, errors = [None] * world_size, [None] * world_size
    turn = threading.Lock()

    def run(rank):
        try:
            with turn:
                results[rank] = fn(rank, world_size, store)
        except BaseException as e:     # handed to the test below
            errors[rank] = e

    waits = {name: getattr(M, name)
             for name in ("make_mesh", "exchange", "all_gather_rows")}
    for name, real in waits.items():
        setattr(M, name, _waiting(real, turn))
    try:
        threads = [threading.Thread(target=run, args=(r,), daemon=True)
                   for r in range(world_size)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
    finally:
        for name, real in waits.items():
            setattr(M, name, real)
    alive = [r for r, t in enumerate(threads) if t.is_alive()]
    assert not alive, f"ranks {alive} still running after {timeout} s"
    for e in errors:
        if e is not None:
            raise e
    return results


def cpu_mesh(n_data, n_seq, rank, world_size, store, timeout=TIMEOUT):
    return M.make_mesh(n_data, n_seq, rank=rank, world_size=world_size,
                       store=store, device="cpu", timeout=timeout)


def fail_on_rank_one(rank, world_size, store):
    if rank == 1:
        raise RuntimeError("rank one fails")
    return rank


def sleep_long(rank, world_size, store):
    time.sleep(60)


def two_process_worker(rank, world_size, store, data, tail, syms, framebits):
    """A real two-process job on gloo: the ring on a (1, 2) mesh in both
    forms (the kernel form's kernels as their plain versions) and
    ``decode_sharded`` on the data axis of a (2, 1) mesh."""
    from unittest import mock

    import viterbi_tpu_torch
    from viterbi_tpu_torch.parallel import batch, streaming
    viterbi_tpu_torch.initialize(device="cpu")
    ring = M.make_mesh(1, 2, rank=rank, world_size=world_size,
                       store=dist.PrefixStore("ring", store), device="cpu",
                       timeout=TIMEOUT)
    stream_bits = data.shape[1] // 4
    plain = streaming.make_stream_decoder(ring, stream_bits,
                                          use_kernels=False)(data, tail)
    with mock.patch.object(streaming, "want_kernels", lambda u, d: True):
        kernels = streaming.make_stream_decoder(ring, stream_bits)(data,
                                                                    tail)
    dp = M.make_mesh(2, 1, rank=rank, world_size=world_size,
                     store=dist.PrefixStore("dp", store), device="cpu",
                     timeout=TIMEOUT)
    frames = batch.decode_sharded(syms, framebits, dp)
    return {"ring_plain": plain.numpy(), "ring_kernels": kernels.numpy(),
            "sharded": frames.numpy(), "pid": os.getpid()}


def on_card(rank, world_size, store, n_data, n_seq):
    """A mesh of thread ranks that share ``cuda:0``, over gloo."""
    return M.make_mesh(n_data, n_seq, rank=rank, world_size=world_size,
                       store=store, device=torch.device("cuda", 0),
                       timeout=TIMEOUT)
