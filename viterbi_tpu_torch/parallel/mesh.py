"""Process meshes: the port of ``viterbi_tpu.parallel.mesh``.

The JAX package shards over a ``jax.sharding.Mesh`` of devices with two
axes:

  * "data": independent frames or subchannels (the DP analog),
  * "seq": blocks of one long symbol stream (the SP/CP analog:
    block-overlap Viterbi with a boundary-metric exchange).

Here a mesh is a grid of processes (ranks), each with its own device, and
each axis is a ``torch.distributed`` process group. Rank r sits at
``(r // n_seq, r % n_seq)``, the order of JAX's ``reshape(n_data,
n_seq)``. Its data group is its column of the grid (the ranks that share
its seq index; group rank = data index), its seq group its row (the ranks
that share its data index; group rank = seq index). ``make_mesh`` builds
both groups from one store, with a finite timeout, so a lost peer raises
instead of hanging.

Gloo (ranks on the CPU, or ranks that share a card) takes host tensors
only: ``exchange`` and ``all_gather_rows`` copy a card tensor into pinned
host memory before it is sent and back to the card after it arrives.
With NCCL (each rank on a card of its own) the tensors go as they are.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"
DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a [data, seq] process grid. ``shape``,
    ``coords`` and ``groups`` are keyed by axis name: the grid's size, this
    rank's index and the process group along each axis."""
    shape: dict
    coords: dict
    groups: dict
    rank: int
    device: torch.device


def _new_group(store, rank: int, size: int, timeout, backend: str):
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, size, timeout)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    return dist.ProcessGroupNCCL(store, rank, size, opts)


def make_mesh(n_data: int | None = None, n_seq: int = 1, *, rank: int,
              world_size: int, store, device,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT,
              backend: str = "gloo") -> Mesh:
    """Build this rank's [data, seq] mesh over ``world_size`` ranks.
    Default: every rank on the data axis. ``n_data * n_seq`` must equal
    ``world_size``.

    ``store`` is a ``torch.distributed`` store that every rank of the mesh
    reaches (a ``HashStore`` shared by threads, the ``TCPStore`` or
    ``FileStore`` of a launch); one mesh uses it (wrap it in a
    ``PrefixStore`` to build more), and its timeout becomes ``timeout``.
    ``device`` is this rank's device, explicit: ranks that share a card
    name the same one. Every group waits at most ``timeout`` for its
    peers, set-up included.
    """
    if n_data is None:
        n_data = world_size // n_seq
    if n_data < 1 or n_seq < 1 or n_data * n_seq != world_size:
        raise ValueError(f"a {n_data} x {n_seq} mesh does not fill "
                         f"{world_size} ranks")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside {world_size} ranks")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl needs a card a rank, got {device}")
    store = dist.PrefixStore("viterbi_tpu_torch.mesh", store)
    store.set_timeout(timeout)
    d, s = divmod(rank, n_seq)
    groups = {
        DATA_AXIS: _new_group(dist.PrefixStore(f"data.{s}", store), d,
                              n_data, timeout, backend),
        SEQ_AXIS: _new_group(dist.PrefixStore(f"seq.{d}", store), s, n_seq,
                             timeout, backend)}
    return Mesh({DATA_AXIS: n_data, SEQ_AXIS: n_seq},
                {DATA_AXIS: d, SEQ_AXIS: s}, groups, rank, device)


def local_rows(x, mesh: Mesh):
    """This rank's contiguous rows of a batch (a tensor or a host array)
    that divides over the data axis: the twin of ``data_sharding``."""
    n = mesh.shape[DATA_AXIS]
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not divide over the "
                         f"{n} ranks of the data axis")
    per = x.shape[0] // n
    d = mesh.coords[DATA_AXIS]
    return x[d * per:(d + 1) * per]


def _staged(group) -> bool:
    """Whether the group's backend takes host tensors only (gloo)."""
    return not isinstance(group, getattr(dist, "ProcessGroupNCCL", ()))


def _outgoing(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend takes it: contiguous, on the host for gloo
    (pinned when it comes from a card)."""
    if not _staged(group) or t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _incoming(group, like: torch.Tensor) -> torch.Tensor:
    """An empty buffer shaped like ``like`` where the backend receives."""
    if not _staged(group) or like.device.type == "cpu":
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def exchange(group, tensor: torch.Tensor, dst: int | None,
             src: int | None, tag: int = 0) -> torch.Tensor | None:
    """Point-to-point between neighbours of ``group``: send ``tensor`` to
    group rank ``dst`` (None: send nothing) and receive a tensor of the
    same shape and type from ``src`` (None: receive nothing). Both are
    posted before either is waited on, so a ring of two cannot deadlock.
    Returns what arrived, on ``tensor``'s device, or None."""
    works, got = [], None
    if src is not None:
        got = _incoming(group, tensor)
        works.append(group.recv([got], src, tag))
    if dst is not None:
        out = _outgoing(group, tensor)
        works.append(group.send([out], dst, tag))
    for work in works:
        work.wait()
    if got is None:
        return None
    return got.to(tensor.device, non_blocking=True)


def all_gather_rows(group, tensor: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` (all of one shape), concatenated along
    ``dim`` in group-rank order, on every rank, on ``tensor``'s device."""
    if group.size() == 1:
        return tensor
    mine = _outgoing(group, tensor)
    parts = [_incoming(group, mine) for _ in range(group.size())]
    group.allgather([parts], [mine]).wait()
    return torch.cat(parts, dim).to(tensor.device, non_blocking=True)
