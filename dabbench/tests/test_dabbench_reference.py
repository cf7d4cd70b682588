"""The plain reference and the generator against what they must do: the
Viterbi decoder returns the bits sent on noiseless frames and equals the
program's golden model on noisy ones; the RS decoder corrects five byte
errors, returns -1 on nine and equals the golden model on random words
and the reference's traps; the superframe check and the export's buffer
follow RScheckSuperframe."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from dabbench.gen import channel as G
from dabbench.reference import rs as R
from dabbench.reference import viterbi as V

ROOT = Path(__file__).resolve().parents[2]


def _golden():
    from viterbi_tpu_torch import golden
    return golden


def _traps():
    spec = importlib.util.spec_from_file_location(
        "torch_rs_traps", ROOT / "tests" / "torch_rs_traps.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("framebits", [8, 96, 768])
def test_noiseless_frames_decode_to_the_bits_sent(framebits):
    gen = torch.Generator().manual_seed(framebits)
    bits = torch.randint(0, 2, (6, framebits), generator=gen)
    hard = G.conv_encode(bits)
    soft = torch.where(hard != 0, 255, 0)
    got = V.decode(soft, framebits)
    want = np.packbits(bits.numpy().astype(np.uint8), axis=1)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("ebn0", [0.0, 2.0])
def test_viterbi_equals_the_golden_model_on_noisy_frames(ebn0):
    signal = {"code_rate": [1, 4], "ebn0_db": ebn0, "gain": 32.0,
              "offset": 127.5, "clip": 255, "neutral": 127}
    gen = torch.Generator().manual_seed(5)
    _, syms = G.make_frames(24, 192, signal, gen, "cpu")
    want = _golden().deconvolve_many(192, syms.numpy())
    assert np.array_equal(V.decode(syms, 192).numpy(), want)


def test_viterbi_equals_the_golden_model_on_punctured_frames():
    signal = {"protection": {"profile": "A", "level": 3},
              "code_rate": [1, 2], "ebn0_db": 1.5, "gain": 32.0,
              "offset": 127.5, "clip": 255, "neutral": 127}
    gen = torch.Generator().manual_seed(9)
    _, syms = G.make_frames(12, 192, signal, gen, "cpu")
    assert (syms == 127).any()
    want = _golden().deconvolve_many(192, syms.numpy())
    assert np.array_equal(V.decode(syms, 192).numpy(), want)


def test_the_masks_equal_the_programs_eep_tables():
    from viterbi_tpu_torch.models import puncture
    for kbps in (8, 16, 32, 48, 64, 96, 128):
        for level in (1, 2, 3, 4):
            want = puncture.frame_mask(kbps, level, "A").astype(bool)
            assert np.array_equal(G.eep_mask(kbps, level, "A"), want)


def _codeword(seed):
    gen = torch.Generator().manual_seed(seed)
    msg = torch.randint(0, 256, (1, R.KK), generator=gen, dtype=torch.int64)
    return G.rs_encode(msg)[0].to(torch.int64)


def test_rs_encoder_equals_the_golden_encoder():
    gen = torch.Generator().manual_seed(3)
    msg = torch.randint(0, 256, (20, R.KK), generator=gen, dtype=torch.int64)
    want = _golden().rs_encode_many(msg.numpy().astype(np.uint8))
    assert np.array_equal(G.rs_encode(msg).numpy(), want)


def test_rs_corrects_five_byte_errors_and_fails_on_nine():
    rng = np.random.default_rng(4)
    clean = _codeword(1)
    rows, counts = [], []
    for n_err in (0, 5, 9):
        for _ in range(4):
            cw = clean.clone()
            pos = torch.from_numpy(rng.choice(R.N, n_err, replace=False))
            cw[pos] ^= torch.from_numpy(rng.integers(1, 256, n_err))
            rows.append(cw)
            counts.append(n_err)
    count, corrected = R.decode_codewords(torch.stack(rows))
    for c, fixed, sent, n_err in zip(count, corrected, rows, counts):
        if n_err <= 5:
            assert int(c) == n_err
            assert torch.equal(fixed, clean)
        else:
            assert int(c) == -1
            assert torch.equal(fixed, sent)


def test_rs_equals_the_golden_decoder_on_random_words_and_traps():
    golden, traps = _golden(), _traps()
    rng = np.random.default_rng(11)
    words = [traps.trap_word(t) for t in traps.TRAPS]
    for k in range(60):
        cw = _codeword(100 + k).numpy().copy()
        pos = rng.choice(R.N, k % 12, replace=False)
        cw[pos] ^= rng.integers(1, 256, k % 12)
        words.append(cw)
    words += list(rng.integers(0, 256, (40, R.N)))
    words = np.array(words, dtype=np.int64)
    count, corrected = R.decode_codewords(torch.from_numpy(words))
    for w, c, o in zip(words, count.numpy(), corrected.numpy()):
        gc, go = golden.rs_decode_codeword(w)
        assert gc == c
        assert np.array_equal(go, o)


@pytest.mark.parametrize("rs_dims", [1, 4, 6])
def test_superframe_check_and_export_buffer_follow_rscheck(rs_dims):
    golden = _golden()
    rng = np.random.default_rng(rs_dims)
    sfs = []
    for g in range(6):
        msgs = torch.from_numpy(rng.integers(0, 256, (rs_dims, R.KK)))
        cws = G.rs_encode(msgs).numpy()
        for j in range(rs_dims):
            n_err = (g + j) % 4 * 3              # 0, 3, 6 or 9 errors
            pos = rng.choice(R.N, n_err, replace=False)
            cws[j, pos] ^= rng.integers(1, 256, n_err).astype(np.uint8)
        sfs.append(cws.T.reshape(-1))
    sf = torch.from_numpy(np.array(sfs))
    errors, audio, n_ok = R.check_superframes(sf, rs_dims)
    for g in range(sf.shape[0]):
        want_err, want_out = golden.rs_check_superframe(sf[g].numpy(),
                                                       rs_dims)
        assert int(errors[g]) == want_err
        before = torch.full((rs_dims * R.KK,), 0x5A, dtype=torch.uint8)
        buf = R.export_buffer(audio[g], int(errors[g]), int(n_ok[g]),
                              rs_dims, before).numpy()
        if want_err != -1:
            assert np.array_equal(buf, want_out)
        else:
            # the codewords before the first failure, nothing else
            j = np.arange(rs_dims * R.KK) % rs_dims
            keep = j < int(n_ok[g])
            assert np.array_equal(buf[keep], want_out[keep])
            assert (buf[~keep] == 0x5A).all()


def test_superframes_carry_the_chosen_uncorrectable_codewords():
    signal = {"protection": {"profile": "A", "level": 3},
              "code_rate": [1, 2], "ebn0_db": 12.0, "gain": 32.0,
              "offset": 127.5, "clip": 255, "neutral": 127}
    gen = torch.Generator().manual_seed(2)
    bad = torch.tensor([False, True, False, True])
    _, syms = G.make_superframes(4, 8, signal, gen, bad, "cpu")
    dec = V.decode(syms.reshape(20, -1), 192).reshape(4, -1)
    errors, _, _ = R.check_superframes(dec, G.rs_dims_of(8))
    assert errors.tolist()[1] == -1 and errors.tolist()[3] == -1
    assert errors.tolist()[0] >= 0 and errors.tolist()[2] >= 0


def test_control_symbols_keep_only_their_top_bits():
    s = torch.tensor([0, 1, 127, 128, 255, 256 + 3])
    assert V.soft_bits(s, 7).tolist() == [0, 0, 126, 128, 254, 2]
