"""The port's process meshes and several-process set-up against the JAX
package's device meshes: the rank -> coordinate map and the groups of
``parallel.mesh.make_mesh`` against JAX's ``make_mesh`` device grid,
``local_rows`` against JAX's data sharding, ``local_batch_slice``,
``initialize`` (a no-op alone, a raise on a broken set-up), the two
exchange helpers over 2 and 4 thread ranks, a lost peer raising within
the group's timeout, and ``run_ranks``' failure, time limit and ranks
that exit while it watches them. Ranks
run as threads of this process over one ``HashStore``
(``torch_ranks.thread_ranks``); nothing reaches the network."""

import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_ranks import (TIMEOUT, cpu_mesh, fail_on_rank_one, sleep_long,
                         thread_ranks)

from viterbi_tpu_torch.parallel import distributed as D
from viterbi_tpu_torch.parallel import mesh as M

SHAPES = [(8, 1), (1, 8), (2, 4), (4, 2)]


def _jax_mesh(n_data, n_seq):
    from viterbi_tpu.parallel import mesh as JM
    return JM, JM.make_mesh(n_data=n_data, n_seq=n_seq)


def test_axis_names_match_jax():
    from viterbi_tpu.parallel import mesh as JM
    assert (M.DATA_AXIS, M.SEQ_AXIS) == (JM.DATA_AXIS, JM.SEQ_AXIS)


@pytest.mark.parametrize("n_data,n_seq", SHAPES)
def test_coordinates_and_groups_match_the_jax_device_grid(n_data, n_seq):
    """Rank r of the port's mesh sits where JAX's grid holds device r, and
    each group gathers its members in the grid's order along its axis."""
    JM, jmesh = _jax_mesh(n_data, n_seq)
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)   # [n_data, n_seq]

    def rank(r, n, store):
        m = cpu_mesh(n_data, n_seq, r, n, store)
        me = torch.tensor([r])
        return (m.shape, m.coords, m.rank,
                M.all_gather_rows(m.groups[M.DATA_AXIS], me).tolist(),
                M.all_gather_rows(m.groups[M.SEQ_AXIS], me).tolist())

    for r, (shape, coords, mrank, column, row) in enumerate(
            thread_ranks(rank, n_data * n_seq)):
        assert shape == {M.DATA_AXIS: n_data, M.SEQ_AXIS: n_seq} == \
            dict(jmesh.shape)
        i, j = map(int, np.argwhere(grid == r)[0])
        assert coords == {M.DATA_AXIS: i, M.SEQ_AXIS: j} and mrank == r
        assert column == grid[:, j].tolist() and row == grid[i].tolist()


@pytest.mark.parametrize("n_data,n_seq", SHAPES)
def test_local_rows_match_jax_data_sharding(n_data, n_seq):
    """Each rank's rows are the shard JAX's ``data_sharding`` puts on the
    device at the same place of the grid; host arrays and tensors alike."""
    import jax
    JM, jmesh = _jax_mesh(n_data, n_seq)
    x = np.arange(16 * 3, dtype=np.int32).reshape(16, 3)
    shards = {s.device.id: np.asarray(s.data) for s in
              jax.device_put(x, JM.data_sharding(jmesh)).addressable_shards}
    for r in range(n_data * n_seq):
        m = M.Mesh({M.DATA_AXIS: n_data, M.SEQ_AXIS: n_seq},
                   {M.DATA_AXIS: r // n_seq, M.SEQ_AXIS: r % n_seq}, {}, r,
                   torch.device("cpu"))
        assert np.array_equal(M.local_rows(x, m), shards[r])
        assert np.array_equal(M.local_rows(torch.from_numpy(x), m).numpy(),
                              shards[r])


def test_local_rows_refuse_a_batch_that_does_not_divide():
    m = M.Mesh({M.DATA_AXIS: 4, M.SEQ_AXIS: 1},
               {M.DATA_AXIS: 1, M.SEQ_AXIS: 0}, {}, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        M.local_rows(np.zeros((10, 2)), m)


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 1), (4, 2), (8, 7)])
def test_local_batch_slice(monkeypatch, world, rank):
    """The JAX package's meaning: ``per = global // world``; outside a job
    the whole batch, as JAX's one process sees it."""
    from viterbi_tpu.parallel import distributed as JD
    assert D.local_batch_slice(37) == JD.local_batch_slice(37) == \
        slice(0, 37)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    per = 37 // world
    assert D.local_batch_slice(37) == slice(per * rank, per * (rank + 1))
    assert D.job() == (world, rank)


def _no_launcher(monkeypatch):
    for k in (*D._CLUSTER_ENV, "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(D, "_initialized", False)
    monkeypatch.setattr(D, "_device", None)


def test_initialize_single_process_is_noop(monkeypatch):
    """No explicit set-up and no launcher in the environment: False, and
    the default group stays unmade."""
    _no_launcher(monkeypatch)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    assert D.initialize() is False
    assert calls == [] and not dist.is_initialized()
    # a launcher's variables for one process: still nothing to join
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.initialize() is False and calls == []


def test_initialize_error_propagates(monkeypatch):
    """A broken explicit set-up raises instead of degrading to one
    process."""
    _no_launcher(monkeypatch)

    def boom(*a, **k):
        raise RuntimeError("rendezvous unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="rendezvous unreachable"):
        D.initialize("tcp://127.0.0.1:1", world_size=2, rank=0,
                     device="cpu")
    assert D._initialized is False


def test_initialize_joins_a_launch_with_explicit_backend_and_device(
        monkeypatch, capsys):
    """Under a launcher's variables it joins through ``env://`` with the
    backend its rule gives, and says so."""
    _no_launcher(monkeypatch)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert D.initialize(device="cpu") is True
    (backend,), kw = calls[0]
    assert backend == "gloo" and kw["init_method"] is None
    assert kw["world_size"] == -1 and kw["rank"] == -1
    assert kw["timeout"] == M.DEFAULT_TIMEOUT
    assert "rank 1 of 2 on cpu, backend gloo" in capsys.readouterr().out
    assert D._initialized and D._device == torch.device("cpu")
    assert D.initialize() is True and len(calls) == 1      # latched


def test_device_is_explicit_and_never_moves_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.local_device()
    with pytest.raises(RuntimeError, match="no card"):
        D.local_device("cuda:0")
    assert D.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="no card of its own"):
        D.local_device()
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert D.local_device() == torch.device("cuda", 0)


@pytest.mark.parametrize("local_ranks,cards,want", [
    (1, 1, "nccl"), (4, 4, "nccl"), (2, 1, "gloo"), (8, 4, "gloo")])
def test_default_backend(monkeypatch, local_ranks, cards, want):
    """gloo where ranks share a card or run on the CPU, nccl where each
    has a card of its own."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_ranks))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert D._default_backend(torch.device("cuda", 0)) == want
    assert D._default_backend(torch.device("cpu")) == "gloo"


def test_make_node_mesh_needs_initialize(monkeypatch):
    monkeypatch.setattr(D, "_initialized", False)
    with pytest.raises(RuntimeError, match="initialize"):
        D.make_node_mesh()


@pytest.mark.parametrize("kw,match", [
    (dict(n_data=3, n_seq=3), "does not fill"),
    (dict(n_data=None, n_seq=3), "does not fill"),
    (dict(rank=8), "outside"),
    (dict(backend="mpi"), "backend"),
    (dict(backend="nccl"), "card a rank")])
def test_make_mesh_validates(kw, match):
    args = dict(n_data=None, n_seq=1, rank=0, world_size=8,
                store=dist.HashStore(), device="cpu") | kw
    with pytest.raises(ValueError, match=match):
        M.make_mesh(**args)


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_sends_to_neighbours(world):
    """Each rank sends right and receives from the left, then the other
    way round with another tag; the ends send or receive nothing."""
    def rank(r, n, store):
        m = cpu_mesh(1, n, r, n, store)
        g = m.groups[M.SEQ_AXIS]
        t = torch.full((3, 5), r, dtype=torch.int32)
        right = M.exchange(g, t, r + 1 if r < n - 1 else None,
                           r - 1 if r else None, tag=0)
        left = M.exchange(g, t * 10, r - 1 if r else None,
                          r + 1 if r < n - 1 else None, tag=1)
        ring = M.exchange(g, t + 100, (r + 1) % n, (r - 1) % n, tag=2)
        return right, left, ring

    for r, (right, left, ring) in enumerate(thread_ranks(rank, world)):
        assert (right is None) == (r == 0) and (left is None) == \
            (r == world - 1)
        if right is not None:
            assert right.dtype == torch.int32 and (right == r - 1).all()
        if left is not None:
            assert (left == 10 * (r + 1)).all()
        assert ring.shape == (3, 5) and (ring == 100 + (r - 1) % world).all()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather_rows_in_rank_order(world, dim):
    def rank(r, n, store):
        m = cpu_mesh(n, 1, r, n, store)
        t = torch.arange(6, dtype=torch.uint8).reshape(2, 3) + 10 * r
        return M.all_gather_rows(m.groups[M.DATA_AXIS], t, dim)

    want = torch.cat([torch.arange(6, dtype=torch.uint8).reshape(2, 3)
                      + 10 * r for r in range(world)], dim)
    for got in thread_ranks(rank, world):
        assert got.dtype == torch.uint8 and torch.equal(got, want)


def test_lost_peer_raises_within_the_timeout():
    """A peer that never sends: the receive raises once the group's
    timeout has passed, it does not hang."""
    short = datetime.timedelta(seconds=2)

    def rank(r, n, store):
        m = cpu_mesh(1, 2, r, n, store, timeout=short)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            # rank 1 stays alive but waits for a message of another tag
            M.exchange(m.groups[M.SEQ_AXIS], torch.zeros(4), None, 1 - r,
                       tag=r)
        return time.monotonic() - t0

    waited = thread_ranks(rank, 2, timeout=30)[0]
    assert 1.5 <= waited < 10, waited


def test_missing_peer_at_set_up_raises_within_the_timeout():
    short = datetime.timedelta(seconds=2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):     # the store's wait timing out
        M.make_mesh(1, 2, rank=0, world_size=2, store=dist.HashStore(),
                    device="cpu", timeout=short)
    assert time.monotonic() - t0 < 10


def test_run_ranks_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited"):
        D.run_ranks(fail_on_rank_one, 2, timeout=60)


def test_run_ranks_ends_ranks_past_their_time_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not done within 3 s"):
        D.run_ranks(sleep_long, 2, timeout=3)
    assert time.monotonic() - t0 < 30


class _RanksThatExitWhileWatched:
    """A spawn context whose processes run their rank at ``start`` and
    report ``exitcode`` None for the first ``alive_reads`` reads (over all
    ranks together), 0 after: the ranks end while ``run_ranks`` looks at
    them, between its check that one is alive and its join."""

    def __init__(self, alive_reads):
        self.reads = 0
        self.alive_reads = alive_reads
        self.joined = []

    def Process(self, target, args):    # noqa: N802 (multiprocessing's name)
        ctx = self

        class Proc:
            @property
            def exitcode(self):
                ctx.reads += 1
                return None if ctx.reads <= ctx.alive_reads else 0

            def start(self):
                target(*args)

            def join(self, timeout=None):
                ctx.joined.append(timeout)

            def kill(self):
                raise AssertionError("killed a rank that had ended")

        return Proc()


@pytest.mark.parametrize("world,alive_reads", [(1, 2), (2, 3), (2, 4)])
def test_run_ranks_survives_ranks_exiting_between_check_and_join(
        monkeypatch, world, alive_reads):
    """The ranks end after the loop's check that one is alive and before
    it picks one to join; run_ranks returns their results all the same (a
    loop that picks the rank from a second read of exitcode finds none
    there and raises StopIteration)."""
    ctx = _RanksThatExitWhileWatched(alive_reads)
    monkeypatch.setattr(D.multiprocessing, "get_context",
                        lambda method: ctx)
    got = D.run_ranks(lambda rank, world_size, store: (rank, world_size),
                      world, timeout=60)
    assert got == [(r, world) for r in range(world)]
    assert ctx.reads > alive_reads and ctx.joined


def test_timeout_constant_is_finite():
    assert TIMEOUT.total_seconds() <= 60
    assert M.DEFAULT_TIMEOUT.total_seconds() <= 60
