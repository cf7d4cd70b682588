"""The port's data-parallel paths against the JAX package's, bit for bit:
``parallel.batch.decode_sharded`` against JAX's ``batch.decode_sharded``
on its 8-device mesh and against golden, on 1, 2 and 8 thread ranks and
on each rung the dispatcher can take here (``cuda_fused``'s kernels as
their plain versions); ``models.dab.decode_ensemble_sharded`` against
JAX's on 2 and 4 ranks, clean and with uncorrectable superframes; one
real two-process job over gloo and a ``FileStore``. On the card (marker
``cuda``) thread ranks that share ``cuda:0`` launch kernels A and B each,
equal to the one-process call."""

import os
import tempfile

import numpy as np
import pytest
import torch
from torch_ranks import cpu_mesh, on_card, thread_ranks, two_process_worker

import viterbi_tpu_torch
from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.models import dab
from viterbi_tpu_torch.ops import _build
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops import traceback as tb
from viterbi_tpu_torch.parallel import batch, distributed, streaming
from viterbi_tpu_torch.runtime import config as config_mod
from viterbi_tpu_torch.runtime import dispatch


@pytest.fixture(autouse=True)
def _fresh_config(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    viterbi_tpu_torch.initialize(device="cpu")
    yield
    viterbi_tpu_torch.initialize()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda", 0)


def _rung(monkeypatch, name):
    monkeypatch.setattr(dispatch.state(), "variant",
                        dispatch.VARIANTS.index(name))


def _sharded(syms, framebits, n_data, n_seq=1, **kw):
    """``decode_sharded`` on n_data * n_seq thread ranks: every rank's
    output."""
    return [o.numpy() for o in thread_ranks(
        lambda r, n, st: batch.decode_sharded(
            syms, framebits, cpu_mesh(n_data, n_seq, r, n, st), **kw),
        n_data * n_seq)]


@pytest.mark.parametrize("framebits,block", [(48, 8), (96, 32), (768, 64)])
def test_decode_sharded_matches_jax_and_golden(framebits, block):
    from viterbi_tpu.parallel import batch as JB
    from viterbi_tpu.parallel import mesh as JM
    _, syms = channel.make_frames(16, framebits, seed=framebits)
    want = np.asarray(JB.decode_sharded(syms.astype(np.int32), framebits,
                                        JM.make_mesh(), block=block))
    assert np.array_equal(want, golden.deconvolve_many(framebits, syms))
    for got in _sharded(syms, framebits, 8, block=block):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("rung,block", [
    ("torch_scan", 64), ("torch_blocked", 8), ("torch_blocked", 64),
    ("torch_blocked", None), ("cuda_fused", 64)])
def test_decode_sharded_takes_the_dispatchers_rung(monkeypatch, n, rung,
                                                   block):
    """Every rank decodes its rows through the rung the dispatcher holds,
    ``block`` reaching the blocked traceback (None: the config key, as
    ``deconvolve_batch`` takes it); every rank gets the whole batch, equal
    to golden."""
    _rung(monkeypatch, rung)
    calls = {"regs": [], "blocked": [], "scan": []}     # appends: atomic
    regs, blocked, scan = (acs_cuda.forward_regs, tb.chainback_blocked,
                           tb.chainback_scan)

    def spy_regs(*a, **k):
        calls["regs"].append(1)
        return regs(*a, **k)

    def spy_blocked(d, fb, block):
        calls["blocked"].append(block)
        return blocked(d, fb, block=block)

    def spy_scan(*a, **k):
        calls["scan"].append(1)
        return scan(*a, **k)

    monkeypatch.setattr(acs_cuda, "forward_regs", spy_regs)
    monkeypatch.setattr(tb, "chainback_blocked", spy_blocked)
    monkeypatch.setattr(tb, "chainback_scan", spy_scan)
    framebits = 96
    _, syms = channel.make_frames(16, framebits, seed=n)
    want = golden.deconvolve_many(framebits, syms)
    for got in _sharded(syms, framebits, n, block=block):
        assert np.array_equal(got, want)
    used = {"torch_scan": len(calls["scan"]),
            "torch_blocked": len(calls["blocked"]),
            "cuda_fused": len(calls["regs"])}
    assert used[rung] == n and sum(used.values()) == n, used
    if rung == "torch_blocked":
        assert calls["blocked"] == [api_block(framebits, block)] * n


def api_block(framebits, block):
    return tb.block_for(framebits,
                        block or dispatch.state().config.traceback_block)


def test_decode_sharded_over_the_data_axis_of_a_two_axis_mesh():
    """On a (2, 4) mesh the seq ranks of a row decode the same rows, as
    JAX's data sharding replicates along seq."""
    _, syms = channel.make_frames(8, 48, seed=4)
    for got in _sharded(syms, 48, 2, 4):
        assert np.array_equal(got, golden.deconvolve_many(48, syms))


def test_decode_sharded_refuses_a_batch_that_does_not_divide():
    _, syms = channel.make_frames(10, 48, seed=1)
    with pytest.raises(ValueError, match="does not divide"):
        _sharded(syms, 48, 4)


def test_decode_sharded_off_the_byte_grid_matches_jax():
    from viterbi_tpu.parallel import batch as JB
    from viterbi_tpu.parallel import mesh as JM
    _, syms = channel.make_frames(8, 100, seed=100)
    want = np.asarray(JB.decode_sharded(syms.astype(np.int32), 100,
                                        JM.make_mesh(n_data=4), block=4))
    for got in _sharded(syms, 100, 4):
        assert np.array_equal(got, want)


def _superframes(rng, errs_per_sf, kbps=32, ebn0_db=7.0):
    """(audio [B, rs_dims, 110], int32 symbols [B, 5, 4*(framebits+6)]):
    ``errs_per_sf[i]`` byte errors planted in codeword 0 of superframe i
    before the convolutional encoder (nine: uncorrectable)."""
    cfg = dab.SubchannelConfig(kbps)
    B = len(errs_per_sf)
    audio = rng.integers(0, 256, (B, cfg.rs_dims, C.RS_KK), dtype=np.uint8)
    cws = golden.rs_encode_many(audio.reshape(-1, C.RS_KK)) \
        .reshape(B, cfg.rs_dims, C.RS_N)
    for i, e in enumerate(errs_per_sf):
        pos = rng.choice(C.RS_N, e, replace=False)
        cws[i, 0, pos] ^= rng.integers(1, 256, e).astype(np.uint8)
    bits = np.unpackbits(cws.transpose(0, 2, 1).reshape(B, -1), axis=1) \
        .reshape(B * dab.SUPERFRAME_FRAMES, cfg.framebits)
    syms = np.stack([channel.awgn_soft_symbols(h, rng, ebn0_db=ebn0_db)
                     for h in channel.encode_batch(bits)])
    return audio, syms.reshape(B, dab.SUPERFRAME_FRAMES, -1).astype(np.int32)


@pytest.mark.parametrize("n_data", [2, 4])
@pytest.mark.parametrize("case", ["clean", "planted"])
def test_ensemble_matches_jax(n_data, case):
    import jax
    from viterbi_tpu.models import dab as JD
    from viterbi_tpu.parallel import mesh as JM
    errs = [0] * 4 if case == "clean" else [9, 3, 0, 9]
    audio, syms = _superframes(np.random.default_rng(n_data), errs)
    jmesh = JM.make_mesh(n_data=n_data, n_seq=1,
                         devices=jax.devices()[:n_data])
    ja, je = map(np.asarray, JD.decode_ensemble_sharded(syms, 32, jmesh))
    got = thread_ranks(lambda r, n, st: dab.decode_ensemble_sharded(
        syms, 32, cpu_mesh(n_data, 1, r, n, st)), n_data)
    for a, e in got:
        assert a.dtype == torch.uint8 and e.dtype == torch.int32
        assert np.array_equal(a.numpy(), ja) and np.array_equal(e.numpy(), je)
    assert je.tolist() == ([0, 0, 0, 0] if case == "clean"
                           else [-1, 3, 0, -1])
    sent = audio.transpose(0, 2, 1).reshape(4, -1)
    ok = je >= 0
    assert np.array_equal(ja[ok], sent[ok])


def test_ensemble_refuses_a_batch_that_does_not_divide():
    _, syms = _superframes(np.random.default_rng(0), [0] * 3)
    with pytest.raises(ValueError, match="does not divide"):
        thread_ranks(lambda r, n, st: dab.decode_ensemble_sharded(
            syms, 32, cpu_mesh(2, 1, r, n, st)), 2)


def test_sharded_paths_need_a_mesh_or_a_job(monkeypatch):
    monkeypatch.setattr(distributed, "_initialized", False)
    _, syms = channel.make_frames(2, 48, seed=0)
    with pytest.raises(RuntimeError, match="initialize"):
        batch.decode_sharded(syms, 48)
    with pytest.raises(RuntimeError, match="initialize"):
        dab.decode_ensemble_sharded(np.zeros((2, 5, 4 * 774)), 32)


def test_two_real_processes_over_gloo(tmp_path, monkeypatch):
    """Two spawned processes over a ``FileStore`` in ``tmp_path``: the ring
    on a (1, 2) mesh in both forms, bit-equal to the one-process local
    decoder of two blocks, and ``decode_sharded`` on 2 ranks, equal to
    golden."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    stream_bits, framebits = 2 * 384, 96
    _, ssyms = channel.make_frames(2, stream_bits, seed=7)
    data, tail = ssyms[:, :4 * stream_bits], ssyms[:, 4 * stream_bits:]
    _, syms = channel.make_frames(4, framebits, seed=8)
    results = distributed.run_ranks(
        two_process_worker, 2, (data, tail, syms, framebits), timeout=120)
    local = streaming.make_local_stream_decoder(
        stream_bits, 2, use_kernels=False, device="cpu")(data, tail).numpy()
    ovl, warm, ckpt = streaming._plan_block_layout(384, None, None, True)
    local_k = streaming.decode_kernels(
        torch.from_numpy(data), torch.from_numpy(tail), 2, 384, ovl, warm,
        ckpt).numpy()
    assert len({r["pid"] for r in results} | {os.getpid()}) == 3
    for r in results:
        assert np.array_equal(r["ring_plain"], local)
        assert np.array_equal(r["ring_kernels"], local_k)
        assert np.array_equal(r["sharded"],
                              golden.deconvolve_many(framebits, syms))


# --- on the card: thread ranks that share cuda:0 ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_card_decode_sharded_launches_a_and_b_in_every_rank(cuda, n):
    viterbi_tpu_torch.initialize(device=cuda)
    assert dispatch.VARIANTS[dispatch.state().variant] == "cuda_fused"
    _, syms = channel.make_frames(64 * n, 3072, seed=n)
    want = viterbi_tpu_torch.deconvolve_batch(3072, syms)[1]

    a0, b0 = _build.ACS_REGS.launches, _build.TB_WALK.launches
    got = thread_ranks(lambda r, world, st: batch.decode_sharded(
        syms, 3072, on_card(r, world, st, n, 1)), n)
    torch.cuda.synchronize()
    # one launch of each kernel a rank (the counters are the process's)
    assert _build.ACS_REGS.launches - a0 == n
    assert _build.TB_WALK.launches - b0 == n
    for out in got:
        assert out.is_cuda and np.array_equal(out.cpu().numpy(), want)


@pytest.mark.cuda
def test_card_ensemble_equals_the_one_process_chain(cuda):
    _, syms = _superframes(np.random.default_rng(5), [0, 9, 3, 0])
    want_a, want_e = dab.decode_audio_superframes(syms, 32)
    a0 = _build.ACS_REGS.launches
    got = thread_ranks(lambda r, n, st: dab.decode_ensemble_sharded(
        syms, 32, on_card(r, n, st, 2, 1)), 2)
    assert _build.ACS_REGS.launches - a0 == 2
    for a, e in got:
        assert a.is_cuda and torch.equal(a, want_a) and torch.equal(e, want_e)
