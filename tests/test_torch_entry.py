"""The port's entry points (``viterbi_tpu_torch.entry``) against
``__graft_entry__.py`` and the JAX package, bit for bit: ``entry(device=
"cpu")``'s example arguments and its output against the JAX ``entry()``'s
function on the CPU; the dryrun's rank body on 2 and 4 thread ranks, its
inputs against those ``__graft_entry__.dryrun_multichip`` draws and each
output against the JAX package's XLA functions on them (the JAX dryrun
runs with its calls recorded); one ``dryrun_multichip(2, device="cpu")``
through spawned processes; the raise without a card. On the card (marker
``cuda``): ``entry()`` through kernels A and B."""

import numpy as np
import pytest
import torch
from torch_ranks import thread_ranks

import __graft_entry__
from viterbi_tpu_torch import entry, golden
from viterbi_tpu_torch.tools import _record


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda", 0)


def test_entry_matches_the_jax_entry():
    jfn, (jsyms,) = __graft_entry__.entry()
    fn, (syms,) = entry.entry(device="cpu")
    assert syms.dtype == torch.int32 and syms.device.type == "cpu"
    assert np.array_equal(syms.numpy(), np.asarray(jsyms))
    got = fn(syms)
    assert got.dtype == torch.uint8 and got.shape == (16, 384)
    assert np.array_equal(got.numpy(), np.asarray(jfn(jsyms)))


def test_without_a_card_the_entry_points_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry.entry, lambda: entry.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _jax_dryrun(n, monkeypatch):
    """``__graft_entry__.dryrun_multichip(n)`` with its package calls
    recorded: {path: [(inputs, outputs)]}. The Pallas ring (interpret mode)
    is answered by the XLA ring on the same inputs, recorded once."""
    import jax

    from viterbi_tpu.models import dab
    from viterbi_tpu.ops import rs
    from viterbi_tpu.parallel import batch, streaming
    calls = {"dp": [], "ring": [], "rs": [], "ensemble": []}

    def record(path, fn, keep=lambda args, kw: True):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            if keep(args, kw):
                calls[path].append((args, jax_to_np(out)))
            return out
        return rec

    real_stream = streaming.decode_stream

    def xla_stream(syms, framebits, mesh, use_pallas=False, **kw):
        kw.pop("interpret", None)
        return real_stream(syms, framebits, mesh, use_pallas=False, **kw)

    monkeypatch.setattr(batch, "decode_sharded",
                        record("dp", batch.decode_sharded))
    monkeypatch.setattr(streaming, "decode_stream", record(
        "ring", xla_stream, lambda args, kw: not kw.get("use_pallas")))
    monkeypatch.setattr(rs, "rs_decode_blocks", record(
        "rs", rs.rs_decode_blocks,
        lambda args, kw: not isinstance(args[0], jax.core.Tracer)))
    monkeypatch.setattr(dab, "decode_ensemble_sharded",
                        record("ensemble", dab.decode_ensemble_sharded))
    __graft_entry__.dryrun_multichip(n)
    return calls


def jax_to_np(out):
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_rank_matches_the_jax_dryrun(n, monkeypatch):
    want = _jax_dryrun(n, monkeypatch)
    inp = entry.dryrun_inputs(n)
    # the same inputs as the JAX dryrun draws
    (dp_args, dp_out), = want["dp"]
    assert np.array_equal(dp_args[0], inp["dp_syms"])
    assert len(want["ring"]) == len(inp["rings"]) == len(
        entry.ring_depths(n))
    (rs_args, rs_out), = want["rs"]
    assert np.array_equal(np.asarray(rs_args[0]), inp["rs_codewords"])
    (ens_args, ens_out), = want["ensemble"]
    assert np.array_equal(ens_args[0], inp["ens_syms"])
    # every rank's outputs against the JAX package's
    res = thread_ranks(lambda r, w, st: entry.dryrun_rank(r, w, st, "cpu"),
                       n)
    for rank, got in enumerate(res):
        assert np.array_equal(got["dp"], dp_out)
        for (args, out), n_seq in zip(want["ring"], entry.ring_depths(n)):
            assert np.array_equal(args[0], inp["rings"][n_seq])
            if rank < (n // n_seq) * n_seq:
                assert np.array_equal(got["rings"][n_seq], out)
        for g, w in zip(got["rs"], rs_out):
            assert np.array_equal(g, w)
        for g, w in zip(got["ensemble"], ens_out):
            assert np.array_equal(g, w)
        assert set(got["launches"]) == {"dp", "ensemble"} | {
            f"ring {d}" for d in entry.ring_depths(n)}


def test_dryrun_multichip_through_spawned_processes(capsys):
    ranks = entry.dryrun_multichip(2, device="cpu")
    assert len(ranks) == 2
    inp = entry.dryrun_inputs(2)
    for r in ranks:
        assert np.array_equal(r["dp"], np.packbits(inp["dp_bits"], axis=1))
        assert np.array_equal(r["rings"][2], golden.deconvolve_many(
            2 * entry.RING_BLOCK_BITS, inp["rings"][2]))
    assert "dryrun_multichip OK: DP 2-way" in capsys.readouterr().out


@pytest.mark.cuda
def test_entry_runs_kernels_a_and_b_on_the_card(cuda):
    fn, (syms,) = entry.entry()
    assert syms.device.type == "cuda"
    _record.zero_launches()
    out = fn(syms)
    counts = _record.launches()
    assert counts["acs_regs"] == 1 and counts["tb_walk"] == 1, counts
    assert np.array_equal(out.cpu().numpy(), golden.deconvolve_many(
        entry.FRAMEBITS, syms.cpu().numpy()))
