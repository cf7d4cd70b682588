"""The T-DMB stream-mode chain (``models.tdmb.decode_ts_streams``) and its
outer stages: RS(204,188) (``ops.rs.rs_decode_packets``, kernel I's
packets entry, and its plain version) and the I = 12, M = 17
deinterleaver (``ops.deinterleave``, kernel K, and its plain version),
against the plain reference ``viterbi_tpu_torch.reference.tdmb``, written
from the standards one byte and one codeword at a time.

RS(204,188) corrects any 1 to 8 byte errors; 12 give -1 or the
reference's own answer; an error the locator puts into the shortening
pad makes the codeword -1 (the textbook rule, where RS(120,110) keeps the
DLL's count); deinterleaving the interleaver's output is a 2244-byte
delay; calls that carry the FIFOs equal one call; the whole chain equals
the reference at 136 kbit/s over 14 CIFs with kernels off, the fresh
streams' zero fill and a failed packet included; its span tree and
counters. The ``cuda`` tests hold kernel K and both codes of kernel I to
their plain versions, kernels A and B to theirs at 13 056-bit frames,
and the chain on the card to its plain path and the reference; they skip
without a card.

    python -m pytest tests/test_torch_tdmb.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.models import tdmb
from viterbi_tpu_torch.ops import acs, acs_cuda, counts
from viterbi_tpu_torch.ops import deinterleave as dl
from viterbi_tpu_torch.ops import rs as rs_ops
from viterbi_tpu_torch.ops import traceback as tb
from viterbi_tpu_torch.reference import tdmb as R
from viterbi_tpu_torch.runtime import calllog

KBPS = 136                       # two packets a CIF
CIFS = 14
PROTECTION = ("A", 3)


@pytest.fixture(autouse=True)
def _fresh():
    calllog.spans(clear=True)
    yield
    calllog.configure(False)
    calllog.spans(clear=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels I and K build with nvcc "
                    "for sm_90a and run only on the card)")
    return torch.device("cuda", 0)


def _codewords(n, seed):
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (n, R.K), dtype=np.uint8)
    return msgs, np.stack([R.rs_encode(m) for m in msgs])


def _hit(cws, errs, seed):
    """``cws`` with errs[i] byte errors in codeword i, at random places."""
    rng = np.random.default_rng(seed)
    out = cws.copy()
    for i, e in enumerate(errs):
        pos = rng.choice(R.N, e, replace=False)
        out[i, pos] ^= rng.integers(1, 256, e).astype(np.uint8)
    return out


def _reference(rx):
    got = [R.decode_codeword(cw) for cw in rx]
    return (np.array([c for c, _ in got], np.int32),
            np.stack([d for _, d in got]))


def _streams(S, T, kbps, seed, esn0_db=-1.0, bad=()):
    return channel.make_ts_streams(S, T, kbps, seed, esn0_db, bad,
                                   PROTECTION)


# --------------------------------------------------------------------------
# RS(204,188)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("errors", range(0, 9))
def test_rs204_corrects_any_1_to_8_byte_errors(errors):
    msgs, cws = _codewords(24, seed=errors)
    rx = _hit(cws, [errors] * len(cws), seed=100 + errors)
    count, data = rs_ops.rs_decode_packets(torch.from_numpy(rx))
    assert count.dtype == torch.int32 and data.dtype == torch.uint8
    assert count.tolist() == [errors] * len(cws)
    assert np.array_equal(data.numpy(), msgs)
    want_count, want_data = _reference(rx)
    assert np.array_equal(count.numpy(), want_count)
    assert np.array_equal(data.numpy(), want_data)


@pytest.mark.parametrize("errors", [9, 12, 16, 40])
def test_rs204_beyond_8_errors_gives_minus_1_or_the_references_answer(
        errors):
    _, cws = _codewords(40, seed=errors)
    rx = _hit(cws, [errors] * len(cws), seed=7 * errors)
    count, data = rs_ops.rs_decode_packets(torch.from_numpy(rx))
    want_count, want_data = _reference(rx)
    assert np.array_equal(count.numpy(), want_count)
    assert np.array_equal(data.numpy(), want_data)
    failed = count.numpy() < 0
    assert failed.mean() > 0.9
    assert np.array_equal(data.numpy()[failed], rx[failed, :R.K])


@pytest.mark.parametrize("sent_errors", [0, 3, 7])
def test_a_locator_root_in_the_pad_makes_the_codeword_uncorrectable(
        sent_errors):
    """A codeword of the unshortened RS(255,239) whose pad is not zero: as
    received, its syndromes are those of an error in the pad (plus
    ``sent_errors`` others), within the code's reach, but the locator's
    root lies outside the 204 sent positions, so the textbook rule gives
    -1 and the bytes as received."""
    rng = np.random.default_rng(sent_errors)
    for q in (0, 17, 50):
        msg = rng.integers(0, 256, 255 - R.NROOTS).astype(np.uint8)
        msg[:R.PAD] = 0
        msg[q] = rng.integers(1, 256)
        full = R.rs_encode(msg)                  # 255 bytes, RS(255,239)
        rx = _hit(full[None, R.PAD:], [sent_errors], seed=q)
        count, data = rs_ops.rs_decode_packets(torch.from_numpy(rx))
        assert count.tolist() == [-1]
        assert np.array_equal(data.numpy(), rx[:, :R.K])
        assert R.decode_codeword(rx[0])[0] == -1


def test_rs204_refuses_a_wrong_shape():
    with pytest.raises(ValueError, match="204"):
        rs_ops.rs_decode_packets(torch.zeros((2, 120), dtype=torch.uint8))


# --------------------------------------------------------------------------
# The deinterleaver
# --------------------------------------------------------------------------


def test_deinterleave_after_interleave_is_a_2244_byte_delay():
    rng = np.random.default_rng(3)
    stream = rng.integers(0, 256, (3, 30 * R.N), dtype=np.uint8)
    sent = np.stack([R.interleave(s) for s in stream])
    got, carry = dl.deinterleave(torch.from_numpy(sent))
    assert dl.DELAY == 2244 and dl.CARRY_BYTES == 1122
    assert (got[:, :dl.DELAY] == 0).all()
    assert np.array_equal(got[:, dl.DELAY:].numpy(), stream[:, :-dl.DELAY])
    for s in range(3):
        want, want_carry = R.deinterleave(sent[s])
        assert np.array_equal(got[s].numpy(), want)
        assert np.array_equal(carry[s].numpy(), want_carry)


@pytest.mark.parametrize("cut", [1, 5, 11, 12, 29])
def test_deinterleave_in_two_calls_with_the_carry_equals_one_call(cut):
    """Cuts of fewer packets than the FIFOs hold (1, 5) included."""
    rng = np.random.default_rng(cut)
    data = torch.from_numpy(rng.integers(0, 256, (2, 30 * R.N),
                                         dtype=np.uint8))
    start = torch.from_numpy(rng.integers(0, 256, (2, dl.CARRY_BYTES),
                                          dtype=np.uint8))
    whole, carry = dl.deinterleave(data, start)
    a, c1 = dl.deinterleave(data[:, :cut * R.N], start)
    b, c2 = dl.deinterleave(data[:, cut * R.N:], c1)
    assert torch.equal(torch.cat([a, b], dim=1), whole)
    assert torch.equal(c2, carry)
    for s in range(2):
        want, want_carry = R.deinterleave(data[s].numpy(), start[s].numpy())
        assert np.array_equal(whole[s].numpy(), want)
        assert np.array_equal(carry[s].numpy(), want_carry)


def test_deinterleave_refuses_a_partial_packet_and_a_wrong_carry():
    with pytest.raises(ValueError, match="multiple of 204"):
        dl.deinterleave(torch.zeros((1, 100), dtype=torch.uint8))
    with pytest.raises(ValueError, match="carry"):
        dl.deinterleave(torch.zeros((2, 204), dtype=torch.uint8),
                        torch.zeros((1, dl.CARRY_BYTES), dtype=torch.uint8))


# --------------------------------------------------------------------------
# The chain
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def received():
    return _streams(2, CIFS, KBPS, seed=11, bad=(1, 9))


@pytest.fixture(scope="module")
def expected(received):
    return R.decode_ts_streams(received, KBPS, PROTECTION)


def test_the_chain_equals_the_reference_with_kernels_off(received, expected):
    got = tdmb.decode_ts_streams(received, KBPS, PROTECTION, device="cpu",
                                 use_kernels=False)
    packets, errors, state = got
    assert packets.shape == (2, CIFS * 2, 188) and errors.shape == (2, 28)
    assert state.shape == (2, 1122) and state.dtype == torch.uint8
    for g, w in zip(got, expected):
        assert torch.equal(g, w)
    fill = tdmb.FILL_PACKETS
    assert fill == 11
    # the fill: zero codewords, sent through the channel like the rest
    assert (packets[:, :fill] == 0).all() and (errors[:, :fill] >= 0).all()
    # the injected packets (1 and 9) come out 11 later as -1; RS corrects
    # bytes in others
    assert (errors[:, fill + 1] == -1).all() and (errors[:, fill + 9] == -1
                                                  ).all()
    assert (errors > 0).any()


@pytest.mark.parametrize("cut", [3, 7])
def test_the_chain_in_two_calls_with_the_state_equals_one_call(
        received, expected, cut):
    a = tdmb.decode_ts_streams(received[:, :cut], KBPS, PROTECTION,
                               device="cpu")
    b = tdmb.decode_ts_streams(received[:, cut:], KBPS, PROTECTION,
                               state=a[2], device="cpu")
    assert torch.equal(torch.cat([a[0], b[0]], dim=1), expected[0])
    assert torch.equal(torch.cat([a[1], b[1]], dim=1), expected[1])
    assert torch.equal(b[2], expected[2])


def test_the_chain_takes_int32_symbols_whose_low_byte_counts(received,
                                                             expected):
    wrapped = received.astype(np.int32) - 256 * 3
    got = tdmb.decode_ts_streams(wrapped, KBPS, PROTECTION, device="cpu")
    for g, w in zip(got, expected):
        assert torch.equal(g, w)


def test_a_noisier_channel_equals_the_reference():
    rx = _streams(1, 14, KBPS, seed=5, esn0_db=-1.5)
    want = R.decode_ts_streams(rx, KBPS, PROTECTION)
    got = tdmb.decode_ts_streams(rx, KBPS, PROTECTION, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] < 0).sum() > 2 and (got[1] > 0).sum() > 2


def test_the_chain_refuses_bad_inputs(received):
    with pytest.raises(ValueError, match="68"):
        tdmb.decode_ts_streams(received, 128, PROTECTION, device="cpu")
    with pytest.raises(ValueError, match=r"\[S, T"):
        tdmb.decode_ts_streams(received[:, :, :-1], KBPS, PROTECTION,
                               device="cpu")
    with pytest.raises(ValueError, match="state"):
        tdmb.decode_ts_streams(received, KBPS, PROTECTION, device="cpu",
                               state=torch.zeros((1, 1122),
                                                 dtype=torch.uint8))


def test_the_chain_is_one_span_tree_with_its_counters(received):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        first = tdmb.decode_ts_streams(received[:, :4], KBPS, PROTECTION,
                                       device="cpu")
        last = tdmb.decode_ts_streams(received[:, 4:], KBPS, PROTECTION,
                                      state=first[2], device="cpu")
    records = calllog.spans()
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["tdmb", "tdmb"]
    for root, (_, errors, _), carried in zip(roots, (first, last),
                                             (0, 2 * 1122)):
        kids = {r.name: r for r in records
                if r.request == root.request and r.parent == "tdmb"}
        assert list(kids) == ["ingest", "depuncture", "viterbi",
                              "deinterleave", "rs"]
        for r in kids.values():
            assert root.t0_ns <= r.t0_ns <= r.t1_ns <= root.t1_ns
        assert kids["deinterleave"].counters == {
            "streams": 2, "carry_bytes": carried, "launches": 0}
        assert kids["rs"].counters == {
            "codewords": errors.numel(), "launches": 0,
            "corrected": int((errors > 0).sum()),
            "failed": int((errors < 0).sum())}
        assert kids["depuncture"].counters["kept_bytes"] > 0


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("S,packets", [(1, 1), (3, 11), (8, 800), (16, 400)])
@pytest.mark.parametrize("fresh", [True, False])
def test_kernel_k_equals_its_plain_version(cuda, S, packets, fresh):
    g = torch.Generator(device=cuda).manual_seed(S * packets)
    data = torch.randint(0, 256, (S, packets * R.N), generator=g,
                         device=cuda, dtype=torch.uint8)
    carry = None if fresh else torch.randint(
        0, 256, (S, dl.CARRY_BYTES), generator=g, device=cuda,
        dtype=torch.uint8)
    counts.zero_launches()
    out, new = dl.deinterleave(data, carry)
    assert counts.only({"deinterleave": 1})
    want, want_new = dl.deinterleave_plain(data.cpu(), None if carry is None
                                           else carry.cpu())
    assert torch.equal(out.cpu(), want) and torch.equal(new.cpu(), want_new)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 17, 1000, 25600])
def test_kernel_i_rs204_equals_its_plain_version(cuda, n):
    _, cws = _codewords(min(n, 512), seed=n)
    cws = np.resize(cws, (n, R.N))
    errs = np.random.default_rng(n).integers(0, 14, n)
    rx = torch.from_numpy(_hit(cws, errs, seed=n + 1))
    counts.zero_launches()
    count, data = rs_ops.rs_decode_packets(rx.to(cuda))
    assert counts.only({"rs_packets": 1})
    want_count, want_data = rs_ops.rs_decode_packets_plain(rx)
    assert torch.equal(count.cpu(), want_count)
    assert torch.equal(data.cpu(), want_data)
    # rows any distance apart
    wide = torch.zeros((n, 256), dtype=torch.uint8)
    wide[:, 20:20 + R.N] = rx
    count2, data2 = rs_ops.rs_decode_packets(wide.to(cuda)[:, 20:20 + R.N])
    assert torch.equal(count2.cpu(), want_count)
    assert torch.equal(data2.cpu(), want_data)


@pytest.mark.cuda
def test_kernel_i_rs204_pad_rule_on_the_card(cuda):
    rng = np.random.default_rng(1)
    rows = []
    for q in range(R.PAD):
        msg = rng.integers(0, 256, 255 - R.NROOTS).astype(np.uint8)
        msg[:R.PAD] = 0
        msg[q] = rng.integers(1, 256)
        rows.append(R.rs_encode(msg)[R.PAD:])
    rx = torch.from_numpy(np.stack(rows))
    count, data = rs_ops.rs_decode_packets(rx.to(cuda))
    assert (count.cpu() == -1).all()
    assert torch.equal(data.cpu(), rx[:, :R.K])


@pytest.mark.cuda
@pytest.mark.parametrize("rs_dims", [1, 4, 16, 48])
def test_kernel_i_rs120_still_equals_its_plain_versions(cuda, rs_dims):
    """The template's RS(120,110) instantiation: both entries against
    their plain versions on superframes with 0 to 12 errors a codeword."""
    rng = np.random.default_rng(rs_dims)
    G = 64
    msgs = rng.integers(0, 256, (G * rs_dims, 110), dtype=np.uint8)
    cws = golden.rs_encode_many(msgs)
    errs = rng.integers(0, 13, len(cws))
    for i, e in enumerate(errs):
        pos = rng.choice(120, e, replace=False)
        cws[i, pos] ^= rng.integers(1, 256, e).astype(np.uint8)
    sf = torch.from_numpy(cws.reshape(G, rs_dims, 120).transpose(0, 2, 1)
                          .reshape(G, -1).copy())
    for zero in (False, True):
        got = rs_ops.rs_check_superframes(sf.to(cuda), rs_dims,
                                          zero_after_fail=zero)
        want = rs_ops.rs_check_superframes_plain(sf, rs_dims,
                                                 zero_after_fail=zero)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    blocks = torch.from_numpy(cws)
    got = rs_ops.rs_decode_blocks(blocks.to(cuda))
    want = rs_ops.rs_decode_blocks_plain(blocks)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("kbps,frames", [(544, 800), (544, 5), (272, 1600)])
def test_kernels_a_and_b_at_long_frames_equal_their_plain_versions(
        cuda, kbps, frames):
    """Frames of 13 056 bits (544 kbit/s), above the DLL's 9216: kernel A
    in the form the batch picks and kernel B's checkpoint walk against the
    plain forward pass and the blocked traceback on the card."""
    fb = 24 * kbps
    g = torch.Generator(device=cuda).manual_seed(frames)
    bits = torch.randint(0, 2, (frames, fb), generator=g, device=cuda)
    syms = channel.soft_on_device(bits, False, g, ebn0_db=1.0)
    counts.zero_launches()
    got = acs_cuda.decode(syms, fb)
    assert counts.launches()["acs_regs"] == 1
    assert counts.launches()["tb_walk"] == 1
    decisions, _ = acs.forward(syms, fb + 6)
    want = tb.chainback_blocked(decisions, fb, block=tb.block_for(fb))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_the_chain_on_the_card_equals_the_reference_and_its_plain_path(
        cuda, received, expected):
    counts.zero_launches()
    got = tdmb.decode_ts_streams(received, KBPS, PROTECTION)
    assert counts.only({"depuncture": 1, "acs_regs": 1, "tb_walk": 1,
                        "deinterleave": 1, "rs_packets": 1})
    for g, w in zip(got, expected):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    a = tdmb.decode_ts_streams(received[:, :5], KBPS, PROTECTION)
    b = tdmb.decode_ts_streams(received[:, 5:], KBPS, PROTECTION,
                               state=a[2])
    assert torch.equal(torch.cat([a[0], b[0]], 1).cpu(), expected[0])
    assert torch.equal(torch.cat([a[1], b[1]], 1).cpu(), expected[1])


@pytest.mark.cuda
def test_the_chain_at_544_kbps_on_the_card_equals_its_plain_path(cuda):
    rx = _streams(2, 3, 544, seed=4, esn0_db=-0.5, bad=(2,))
    got = tdmb.decode_ts_streams(rx, 544, PROTECTION)
    plain = tdmb.decode_ts_streams(torch.from_numpy(rx).to(cuda), 544,
                                   PROTECTION, use_kernels=False)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)
    want = R.decode_ts_streams(rx, 544, PROTECTION)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
