"""Several-process set-up: the port of ``viterbi_tpu.parallel.distributed``.

Under a torch launcher (``torchrun``, or any launch that sets the
``env://`` variables) each process runs the same program;
``initialize()`` joins them into one ``torch.distributed`` job and
``make_node_mesh`` lays a [data, seq] mesh (``parallel.mesh``) over it. A
single process (tests, one card) is a no-op.

Layout policy, as in the JAX package: the "data" axis (independent frames
or subchannels) needs no communication, so it spans nodes; the "seq"
axis (block-overlap streaming, with its boundary exchanges) keeps its
ranks contiguous within a node.

Backend and device are explicit. The device defaults to
``cuda:<local rank>``; a host without a card passes ``device="cpu"``,
and nothing moves to the CPU silently. The backend is gloo where ranks
share a card or run on the CPU, nccl where each rank has a card of its
own; ``initialize`` prints its choice.

``run_ranks`` starts the ranks of a one-host job itself, in fresh
processes over a ``FileStore``, each under a wall-clock limit: the
scaling sweep (``harness.scaling``) uses it.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..runtime.placement import strict_device
from . import mesh as mesh_mod

_initialized = False
_device: torch.device | None = None
_meshes: dict[int, mesh_mod.Mesh] = {}

# Environment markers of a real several-process launch (the torch
# launchers' variables); with WORLD_SIZE > 1 they make initialize() join.
_CLUSTER_ENV = ("TORCHELASTIC_RUN_ID", "MASTER_ADDR")


def local_device(device=None) -> torch.device:
    """This process's device: ``device``, else ``cuda:<LOCAL_RANK>``.
    Raises where that card does not exist (``placement.strict_device``)."""
    if device is not None:
        return strict_device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = strict_device(f"cuda:{local}")
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local} has no card of its own "
            f"({torch.cuda.device_count()} cards): pass device='cuda:0' to "
            f"share one")
    return dev


def _default_backend(device: torch.device) -> str:
    """nccl where every local rank has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, device=None) -> bool:
    """Join the several-process job. Returns True if it has more than
    one process.

    An explicit but broken set-up RAISES rather than degrading to one
    process: a silent fallback would run a job's every shard on one
    process and look like a speed fault. Only the one-process case (no
    explicit ``init_method``, no launcher in the environment) is a no-op.
    """
    global _initialized, _device
    if _initialized:
        return dist.get_world_size() > 1
    explicit = init_method is not None
    auto = any(os.environ.get(k) for k in _CLUSTER_ENV) and \
        int(os.environ.get("WORLD_SIZE", "1")) > 1
    if not explicit and not auto:
        return False          # one process: nothing to do
    device = local_device(device)
    backend = backend or _default_backend(device)
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, timeout=mesh_mod.DEFAULT_TIMEOUT)
    print(f"viterbi_tpu_torch: rank {dist.get_rank()} of "
          f"{dist.get_world_size()} on {device}, backend {backend}")
    _initialized, _device = True, device
    return dist.get_world_size() > 1


def make_node_mesh(n_seq_per_node: int = 1) -> mesh_mod.Mesh:
    """The [data, seq] mesh over the whole job, the twin of
    ``make_pod_mesh``: seq ranks contiguous within a node, data spanning
    nodes. Built once per ``n_seq_per_node`` (every rank must ask for
    the same meshes in the same order); needs ``initialize()``."""
    if not _initialized:
        raise RuntimeError("make_node_mesh needs initialize() first")
    if n_seq_per_node not in _meshes:
        world = dist.get_world_size()
        store = dist.PrefixStore(
            f"viterbi_tpu_torch.node_mesh.{n_seq_per_node}",
            dist.distributed_c10d._get_default_store())
        _meshes[n_seq_per_node] = mesh_mod.make_mesh(
            world // n_seq_per_node, n_seq_per_node, rank=dist.get_rank(),
            world_size=world, store=store, device=_device,
            backend=dist.get_backend())
    return _meshes[n_seq_per_node]


def job() -> tuple[int, int]:
    """(processes in the job, this one's rank): (1, 0) outside one."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def local_batch_slice(global_batch: int) -> slice:
    """The contiguous slice of a global frame batch this process feeds."""
    world, rank = job()
    per = global_batch // world
    return slice(per * rank, per * (rank + 1))


def _rank_main(fn, rank: int, world_size: int, tmp: str, args) -> None:
    """One spawned rank: ``fn`` over the job's FileStore; its result is
    pickled beside the store for the parent."""
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    result = fn(rank, world_size, store, *args)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world_size: int, args: tuple = (),
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, store, *args)`` in ``world_size`` fresh
    processes on this host (``multiprocessing``'s spawn), all reaching one
    ``FileStore``; returns their results in rank order. ``fn`` and
    ``args`` must pickle (``fn`` by its import path).

    Raises if a rank fails, or if the ranks have not all finished within
    ``timeout`` seconds; every process has ended when it returns.
    """
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="viterbi_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, tmp, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                # one snapshot: a rank may exit between two reads of
                # exitcode, and joining one that has ended returns at once
                alive = [p for p in procs if p.exitcode is None]
                if not alive:
                    break
                bad = [(r, p.exitcode) for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(f"rank {bad[0][0]} of {world_size} "
                                       f"exited with code {bad[0][1]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks not done within "
                                       f"{timeout:.0f} s")
                alive[0].join(0.05)
            bad = [(r, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} of {world_size} "
                                   f"exited with code {bad[0][1]}")
            return [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes())
                    for r in range(world_size)]
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join(10)
