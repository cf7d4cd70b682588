"""The DAB+ superframe chain fed punctured symbols, as a receiver takes
them from the MSC (``models.dab.decode_audio_superframes(...,
protection=)``): against the plain reference
(``viterbi_tpu_torch.reference.punctured``) byte for byte, audio and RS
counts, over the EEP profiles, a failed superframe, both ingest paths and
a mixed ensemble; kernel J's plain form (``ops.depuncture``) against
``puncture.depuncture`` narrowed to bytes for every EEP profile; the
chain without ``protection`` as it was, operation for operation; the
``depuncture`` span and its counters. The ``cuda`` tests hold kernel J
and the chain on the card against their plain forms and skip without a
card.

    python -m pytest tests/test_torch_punctured_chain.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.models import dab
from viterbi_tpu_torch.models import puncture as P
from viterbi_tpu_torch.ops import _build
from viterbi_tpu_torch.ops import counts
from viterbi_tpu_torch.ops import depuncture as dp
from viterbi_tpu_torch.reference import punctured as R
from viterbi_tpu_torch.runtime import calllog, placement

CPU = torch.device("cpu")
#: the (bitrate, (profile, level)) groups of the dabplus_punctured
#: ensemble
GROUPS = [(96, ("A", 3)), (96, ("A", 2)), (128, ("A", 4)), (64, ("A", 1)),
          (64, ("A", 3)), (32, ("A", 4))]
#: EEP-A levels 1-4 at 8, 16 and 32 kbit/s (level 2 at 8 kbit/s is the
#: standard's special row), EEP-B levels 1-4 at 32 kbit/s
CASES = [(kbps, ("A", lv)) for kbps in (8, 16, 32) for lv in (1, 2, 3, 4)] \
    + [(32, ("B", lv)) for lv in (1, 2, 3, 4)]


@pytest.fixture(autouse=True)
def _fresh():
    calllog.spans(clear=True)
    yield
    calllog.configure(False)
    calllog.spans(clear=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel J builds with nvcc for "
                    "sm_90a and runs only on the card)")
    return torch.device("cuda", 0)


def _punctured(kbps, protection, errs, seed, esn0_db=2.0, wrap=False):
    """Punctured superframes of one subchannel: int32[B, 5, kept], the
    kept symbols of encoded, noised frames (Es/N0 ``esn0_db`` on every
    sent symbol); ``errs[i]`` byte errors planted in codeword 0 of
    superframe i before the encoder. ``wrap`` adds multiples of 256,
    which leave each symbol's low byte as it is."""
    rng = np.random.default_rng(seed)
    framebits = 24 * kbps
    rs_dims = 5 * framebits // 8 // C.RS_N
    B = len(errs)
    audio = rng.integers(0, 256, (B * rs_dims, C.RS_KK), dtype=np.uint8)
    cws = golden.rs_encode_many(audio).reshape(B, rs_dims, C.RS_N)
    for i, e in enumerate(errs):
        pos = rng.choice(C.RS_N, e, replace=False)
        cws[i, 0, pos] ^= rng.integers(1, 256, e).astype(np.uint8)
    sf = cws.transpose(0, 2, 1).reshape(B, -1)
    bits = np.unpackbits(sf, axis=1).reshape(B * 5, framebits)
    soft = channel.awgn_soft_symbols(channel.encode_batch(bits), rng,
                                     ebn0_db=esn0_db + 6.0)
    keep = R.mask(kbps, protection).numpy()
    rec = soft[:, keep].astype(np.int32).reshape(B, 5, -1)
    if wrap:
        rec = rec + 256 * rng.integers(-4, 5, rec.shape).astype(np.int32)
    return rec


def _same(got, want):
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("kbps,protection", CASES)
def test_chain_matches_the_reference(kbps, protection):
    rec = _punctured(kbps, protection, [0, 3], seed=kbps + protection[1])
    got = dab.decode_audio_superframes(rec, kbps, device="cpu",
                                       protection=protection)
    _same(got, R.decode_superframes(rec, kbps, protection))


def test_a_batch_with_an_uncorrectable_superframe():
    protection = ("A", 3)
    rec = _punctured(32, protection, [2, 9, 0], seed=3, esn0_db=6.0)
    got = dab.decode_audio_superframes(rec, 32, device="cpu",
                                       protection=protection)
    want = R.decode_superframes(rec, 32, protection)
    _same(got, want)
    assert want[1].tolist()[1] == -1 and min(want[1].tolist()[::2]) >= 0


def _stages(records):
    *kids, root = records
    assert root.name == "chain"
    return {r.name: r for r in kids}


@pytest.mark.parametrize("staged", [False, True])
def test_staged_and_direct_ingest_give_the_same_answer(staged, monkeypatch):
    """On either side of ``STAGE_MIN_BYTES``: staged, one byte a kept
    symbol crosses (through the CPU's ring here); direct, the int32
    symbols, whose low bytes kernel J reads. Symbols outside 0..255
    decode as their low bytes."""
    kbps, protection = 16, ("A", 4)
    rec = _punctured(kbps, protection, [1, 0, 4], seed=5, wrap=True)
    monkeypatch.setattr(placement, "STAGE_MIN_BYTES",
                        rec.nbytes if staged else rec.nbytes + 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = dab.decode_audio_superframes(rec, kbps, device="cpu",
                                           protection=protection)
    _same(got, R.decode_superframes(rec, kbps, protection))
    ingest = _stages(calllog.spans())["ingest"].counters
    if staged:
        assert ingest["h2d_bytes"] == rec.size
        assert ingest["staged_chunks"] >= 1
    else:
        assert ingest == {"h2d_bytes": rec.nbytes, "staged_chunks": 0}


def test_a_mixed_ensemble():
    """One call a (bitrate, protection) group, as a multiplex of several
    protection levels decodes: two levels at one bitrate, a rate-1/4 and
    a rate-3/4 group, an EEP-B group and the 8 kbit/s special row."""
    groups = [(16, ("A", 3)), (16, ("A", 1)), (24, ("A", 4)),
              (32, ("B", 3)), (8, ("A", 2))]
    for i, (kbps, protection) in enumerate(groups):
        rec = _punctured(kbps, protection, [i % 3], seed=40 + i)
        got = dab.decode_audio_superframes(torch.from_numpy(rec), kbps,
                                           protection=protection)
        _same(got, R.decode_superframes(rec, kbps, protection))


def test_a_profile_or_wrong_symbols():
    """``protection`` as a ``puncture.Profile``; the wrong width or a
    profile of another bitrate raises."""
    prof = P.eep_profile(16, 2, "A")
    rec = _punctured(16, ("A", 2), [0], seed=8)
    _same(dab.decode_audio_superframes(rec, 16, device="cpu",
                                       protection=prof),
          R.decode_superframes(rec, 16, ("A", 2)))
    with pytest.raises(ValueError, match="symbols must be"):
        dab.decode_audio_superframes(rec[..., :-1], 16, device="cpu",
                                     protection=prof)
    with pytest.raises(ValueError, match="data bits"):
        dab.decode_audio_superframes(rec, 32, device="cpu", protection=prof)


@pytest.mark.parametrize("profile,level", [(p, lv) for p in "AB"
                                           for lv in (1, 2, 3, 4)])
def test_kernel_j_plain_form_against_depuncture_in_bytes(profile, level):
    """Every bitrate of the profile and level: kernel J's plain form,
    from int32 symbols (their low bytes) and from bytes, equals
    ``puncture.depuncture`` narrowed to bytes."""
    step = 8 if profile == "A" else 32
    rng = np.random.default_rng(level)
    for kbps in range(step, 385, step):
        prof = P.eep_profile(kbps, level, profile)
        mask = prof.mask()
        rec = rng.integers(-1000, 1000, (3, int(mask.sum())),
                           dtype=np.int32)
        want = P.depuncture(rec, mask).astype(np.uint8)
        for sym in (torch.from_numpy(rec),
                    torch.from_numpy(rec.astype(np.uint8))):
            got = dp.depuncture_plain(sym, prof)
            assert got.dtype == torch.uint8
            assert np.array_equal(got.numpy(), want), (kbps, sym.dtype)
        assert torch.equal(dp.depuncture(torch.from_numpy(rec), prof),
                           got)


def test_the_step_table_holds_each_steps_mask_and_first_kept_symbol():
    prof = P.eep_profile(32, 3, "A")
    table = dp.step_table(prof, CPU).numpy()
    mask = prof.mask().reshape(-1, C.RATE)
    assert table.shape == (mask.shape[0],)
    assert np.array_equal(table & 15, mask @ [1, 2, 4, 8])
    kept_before = np.concatenate([[0], np.cumsum(mask.sum(axis=1))[:-1]])
    assert np.array_equal(table >> 4, kept_before)
    assert dp.step_table(prof, CPU) is dp.step_table(prof, CPU)
    with pytest.raises(ValueError, match="received must be"):
        dp.depuncture_plain(torch.zeros((2, 7), dtype=torch.uint8), prof)


def _parent_chain(symbols, kbps):
    """The chain without ``protection`` as its parent wrote it."""
    cfg = dab.SubchannelConfig(kbps)
    syms, layout = placement.on_device_words(symbols, CPU)
    B = syms.shape[0]
    flat = syms.reshape(B * dab.SUPERFRAME_FRAMES, -1)
    kernels = placement.want_kernels(None, syms.device)
    frame_bytes = dab.decode_frames(flat, cfg.framebits, kernels,
                                    packed=layout)
    sf = dab.bytes_to_superframes(
        frame_bytes.reshape(B, dab.SUPERFRAME_FRAMES, cfg.frame_bytes), cfg)
    return dab.rs_superframes(sf, cfg.rs_dims, kernels)


def _ops(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events()
                 if not e.name.startswith(calllog.PREFIX)]


@pytest.mark.parametrize("staged", [False, True])
def test_without_protection_the_chain_runs_the_same_operations(
        staged, monkeypatch):
    """``protection=None``: no depuncture stage, and the torch operations
    of the parent's chain, one for one, on either ingest path."""
    def refuse(*args, **kwargs):
        raise AssertionError("the depuncture stage ran")
    monkeypatch.setattr(dab, "depuncture_words", refuse)
    _, syms = channel.make_superframes(2, 8, seed=4)
    syms = syms.astype(np.int32)
    monkeypatch.setattr(placement, "STAGE_MIN_BYTES",
                        syms.nbytes if staged else syms.nbytes + 1)

    def chain():
        return dab.decode_audio_superframes(syms, 8, device="cpu")

    def parent():
        return _parent_chain(syms, 8)

    chain(), parent()           # what either makes at its first call
    got, ops = _ops(chain)
    want, parent_ops = _ops(parent)
    assert ops == parent_ops and len(ops) > 10
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _counting(real, kernel, monkeypatch):
    """``real`` with each call counted as the launch path counts a launch
    of ``kernel`` on a card; the kernel's tally is restored after the
    test."""
    monkeypatch.setattr(kernel, "tally", dict(kernel.tally))

    def wrapper(*args, **kwargs):
        kernel.tally[None] += 1
        return real(*args, **kwargs)
    return wrapper


def test_a_profiler_sees_the_depuncture_stage_with_its_counters(
        tmp_path, monkeypatch):
    """The chain's tree is chain > ingest, depuncture, viterbi, rs; the
    depuncture stage counts the bytes it reads and writes, and kernel J's
    launch where the kernels run (its wrapper counted as on a card)."""
    import json
    kbps, protection = 8, ("A", 1)
    prof = dab.protection_profile(protection, kbps)
    rec = _punctured(kbps, protection, [0, 0], seed=9)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as tr:
        dab.decode_audio_superframes(rec, kbps, device="cpu",
                                     protection=protection)
    path = tmp_path / "trace.json"
    tr.export_chrome_trace(str(path))
    names = [e["name"].removeprefix(calllog.PREFIX) for e in sorted(
        (e for e in json.loads(path.read_text())["traceEvents"]
         if e.get("ph") == "X" and e.get("name", "").startswith(
             calllog.PREFIX)), key=lambda e: e["ts"])]
    assert names == ["chain", "ingest", "depuncture", "viterbi", "rs"]
    records = calllog.spans()
    assert [r.name for r in records[:-1]] == names[1:]
    assert all(r.parent == "chain" for r in records[:-1])
    stage = _stages(records)["depuncture"]
    mother = 2 * 5 * prof.mask().size
    assert stage.counters == {"kept_bytes": rec.nbytes,
                              "mother_bytes": mother, "launches": 0}
    calllog.spans(clear=True)
    monkeypatch.setattr(dp, "depuncture", _counting(
        dp.depuncture, _build.DEPUNCTURE, monkeypatch))
    before = counts.total()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        words = dab.depuncture_words(
            torch.from_numpy(rec.reshape(10, -1)).to(torch.uint8), prof,
            kernels=True)
    assert counts.total() - before == 1
    assert words.dtype == torch.int32 and words.shape == (10, mother // 40)
    (stage,) = calllog.spans()
    assert stage.counters == {"kept_bytes": rec.size, "mother_bytes": mother,
                              "launches": 1}


def test_the_log_sums_the_depuncture_counters_by_stage(tmp_path):
    calllog.configure(True, False, str(tmp_path / "log"))
    for n in (1, 2):
        with calllog.span("api.logged") as root:
            root.record("logged", np.zeros(4, np.int32))
            with calllog.span("depuncture") as sp:
                sp.count(kept_bytes=10 * n, mother_bytes=16 * n, launches=1)
    stage = calllog.summary()["stages"]["depuncture"]
    assert (stage["count"], stage["kept_bytes"], stage["mother_bytes"],
            stage["launches"]) == (2, 30, 48, 2)
    calllog.configure(False)
    assert "kept_bytes 30, mother_bytes 48" in \
        (tmp_path / "log.log").read_text()


# --- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kbps,protection", GROUPS)
def test_kernel_j_matches_its_plain_form_on_the_card(cuda, kbps, protection):
    """From bytes and from int32 symbols, rows apart and not, batches
    that leave a block's rows ragged; one launch a call."""
    prof = dab.protection_profile(protection, kbps)
    kept = prof.transmitted_bits
    rng = np.random.default_rng(kbps)
    for n in (1, 7, 9, 1003):
        rec = torch.from_numpy(rng.integers(-1000, 1000, (n, kept + 5),
                                            dtype=np.int32)).to(cuda)
        for sym in (rec[:, :kept], rec[:, 5:].to(torch.uint8),
                    rec[:, :kept].contiguous()):
            before = _build.DEPUNCTURE.launches
            got = dp.depuncture(sym, prof)
            assert _build.DEPUNCTURE.launches == before + 1
            want = dp.depuncture_plain(sym, prof)
            assert got.is_cuda and torch.equal(got, want), (n, sym.dtype)


@pytest.mark.cuda
def test_kernel_j_strides_over_more_rows_than_the_grid(cuda):
    prof = P.eep_profile(8, 4, "A")
    n = 8 * 65535 + 13
    rec = torch.randint(0, 256, (n, prof.transmitted_bits),
                        dtype=torch.uint8, device=cuda)
    assert torch.equal(dp.depuncture(rec, prof),
                       dp.depuncture_plain(rec, prof))


@pytest.mark.cuda
@pytest.mark.parametrize("kbps,protection", GROUPS)
def test_the_chain_on_the_card_matches_the_plain_only_call(cuda, kbps,
                                                           protection):
    """The six groups of the dabplus_punctured ensemble: a staged host
    batch through kernels J, A, B and I (one launch each) against the
    same symbols through plain versions only on the card, and the first
    superframes against the reference."""
    kept = int(R.mask(kbps, protection).sum())
    B = placement.STAGE_MIN_BYTES // (5 * 4 * kept) + 1
    rec = _punctured(kbps, protection, [0, 9] + [1] * (B - 2), seed=kbps,
                     esn0_db=3.0)
    assert rec.nbytes >= placement.STAGE_MIN_BYTES
    counts.zero_launches()
    got = dab.decode_audio_superframes(rec, kbps, protection=protection)
    n = counts.launches()
    assert (n["depuncture"], n["acs_regs"], n["tb_walk"],
            n["rs_superframes"]) == (1, 1, 1, 1), n
    plain = dab.decode_audio_superframes(torch.from_numpy(rec).to(cuda),
                                         kbps, use_kernels=False,
                                         protection=protection)
    assert got[0].is_cuda
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    _same((got[0][:2], got[1][:2]),
          R.decode_superframes(rec[:2], kbps, protection))


@pytest.mark.cuda
def test_without_protection_the_card_runs_the_same_device_operations(cuda):
    _, syms = channel.make_superframes(64, 32, seed=6)
    syms = syms.astype(np.int32)

    def device_ops(fn):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted(e.key for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)

    def parent():
        cfg = dab.SubchannelConfig(32)
        s, layout = placement.on_device_words(syms, cuda)
        B = s.shape[0]
        fb = dab.decode_frames(s.reshape(B * 5, -1), cfg.framebits, True,
                               packed=layout)
        return dab.rs_superframes(dab.bytes_to_superframes(
            fb.reshape(B, 5, cfg.frame_bytes), cfg), cfg.rs_dims, True)

    assert device_ops(lambda: dab.decode_audio_superframes(syms, 32)) == \
        device_ops(parent)
