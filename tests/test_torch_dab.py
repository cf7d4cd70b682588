"""The port's DAB chains against the JAX package's on the same symbols:
the DAB+ audio-superframe chain (Viterbi -> superframe assembly -> RS)
and the punctured-frame decoders. The JAX side runs without Pallas
(``use_pallas=False``), the port's on the CPU through its plain path.
Tolerance zero: audio bytes, error counts and decoded frames are
identical, and equal to the golden model."""

import numpy as np
import pytest
import torch

import viterbi_tpu.models.dab as JD
import viterbi_tpu.models.puncture as JP
import viterbi_tpu_torch.golden as TG
import viterbi_tpu_torch.models.dab as TD
import viterbi_tpu_torch.models.puncture as TP
from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch.harness import channel

KBPS = 32


def _superframes(rng, errs_per_sf, ebn0_db=7.0):
    """One superframe per entry: (audio [B, rs_dims, 110], int32 symbols
    [B, 5, 4*(framebits+6)]). ``errs_per_sf[i]`` byte errors are planted
    in codeword 0 of superframe i before the convolutional encoder, so the
    Viterbi stage reproduces them and RS has to deal with them."""
    cfg = TD.SubchannelConfig(KBPS)
    B = len(errs_per_sf)
    audio = rng.integers(0, 256, (B, cfg.rs_dims, C.RS_KK), dtype=np.uint8)
    cws = TG.rs_encode_many(audio.reshape(-1, C.RS_KK)) \
        .reshape(B, cfg.rs_dims, C.RS_N)
    for i, e in enumerate(errs_per_sf):
        pos = rng.choice(C.RS_N, e, replace=False)
        cws[i, 0, pos] ^= rng.integers(1, 256, e).astype(np.uint8)
    sf = cws.transpose(0, 2, 1).reshape(B, -1)          # byte-interleaved
    bits = np.unpackbits(sf, axis=1).reshape(B * 5, cfg.framebits)
    syms = np.stack([channel.awgn_soft_symbols(h, rng, ebn0_db=ebn0_db)
                     for h in channel.encode_batch(bits)])
    return audio, syms.reshape(B, 5, -1).astype(np.int32)


def test_subchannel_geometry_matches():
    for kbps in (8, 32, 64, 96, 128, 192, 384):
        want, got = JD.SubchannelConfig(kbps), TD.SubchannelConfig(kbps)
        for name in ("framebits", "frame_bytes", "superframe_bytes",
                     "rs_dims", "symbols_per_frame"):
            assert getattr(got, name) == getattr(want, name)
    assert TD.SUPERFRAME_FRAMES == JD.SUPERFRAME_FRAMES
    for bad in (TD.SubchannelConfig(9), JD.SubchannelConfig(9)):
        with pytest.raises((ValueError, AssertionError)):
            bad.rs_dims


def test_make_superframes_feeds_the_chain():
    """The fixture maker: audio that decodes back, planted failures that
    do not, and the geometry of the subchannel."""
    audio, syms = channel.make_superframes(5, KBPS, seed=2, ebn0_db=5.0,
                                           uncorrectable=2)
    cfg = TD.SubchannelConfig(KBPS)
    assert audio.shape == (5, cfg.rs_dims, C.RS_KK)
    assert syms.shape == (5, 5, cfg.symbols_per_frame)
    assert syms.dtype == np.int32 and syms.min() >= 0 and syms.max() <= 255
    got_a, got_e = TD.decode_audio_superframes(syms, KBPS, device="cpu")
    assert (got_e[:2] == -1).all() and (got_e[2:] >= 0).all()
    sent = audio.transpose(0, 2, 1).reshape(5, -1)
    assert np.array_equal(got_a[2:].numpy(), sent[2:])
    again = channel.make_superframes(5, KBPS, seed=2, ebn0_db=5.0,
                                     uncorrectable=2)
    assert np.array_equal(again[1], syms)            # made from the seed
    with pytest.raises(ValueError, match="whole RS"):
        channel.make_superframes(1, 9)


@pytest.mark.parametrize("case,errs", [
    ("clean", [0, 0]), ("byte_errors", [2, 5, 0]), ("uncorrectable", [1, 9])])
def test_audio_superframes_match_jax_and_golden(case, errs):
    rng = np.random.default_rng(len(case))
    audio, syms = _superframes(rng, errs)
    want_a, want_e = JD.decode_audio_superframes(syms, KBPS)
    got_a, got_e = TD.decode_audio_superframes(syms, KBPS, device="cpu")
    assert got_a.dtype == torch.uint8 and got_e.dtype == torch.int32
    assert np.array_equal(got_a.numpy(), np.asarray(want_a))
    assert np.array_equal(got_e.numpy(), np.asarray(want_e))
    cfg = TD.SubchannelConfig(KBPS)
    for i, e in enumerate(errs):
        frames = TG.deconvolve_many(cfg.framebits, syms[i])
        g_err, g_out = TG.rs_check_superframe(frames.reshape(-1),
                                              cfg.rs_dims)
        assert got_e[i] == g_err
        if e <= 5:
            assert got_e[i] >= e
            assert np.array_equal(
                got_a[i].numpy().reshape(C.RS_KK, cfg.rs_dims).T, audio[i])
            assert np.array_equal(got_a[i].numpy(), g_out)
        else:
            assert got_e[i] == -1


def test_audio_superframes_take_tensors_and_refuse_kernels_on_the_cpu():
    _, syms = _superframes(np.random.default_rng(5), [1])
    a1, e1 = TD.decode_audio_superframes(syms, KBPS, device="cpu")
    a2, e2 = TD.decode_audio_superframes(torch.from_numpy(syms), KBPS)
    assert a2.device.type == "cpu"
    assert torch.equal(a1, a2) and torch.equal(e1, e2)
    a3, _ = TD.decode_audio_superframes(torch.from_numpy(syms), KBPS,
                                        use_kernels=False)
    assert torch.equal(a1, a3)
    with pytest.raises(ValueError, match="CUDA"):
        TD.decode_audio_superframes(torch.from_numpy(syms), KBPS,
                                    use_kernels=True)


def test_bytes_to_superframes_matches():
    cfg = TD.SubchannelConfig(KBPS)
    fb = np.arange(2 * 5 * cfg.frame_bytes, dtype=np.int64) \
        .reshape(2, 5, cfg.frame_bytes) % 251
    got = TD.bytes_to_superframes(torch.from_numpy(fb), cfg)
    assert np.array_equal(got.numpy(),
                          np.asarray(JD.bytes_to_superframes(fb, cfg)))


def _punctured(rng, mask, framebits, n=3, flips=40):
    """Punctured soft frames with a few flipped symbols, and their bits."""
    bits = rng.integers(0, 2, (n, framebits), dtype=np.uint8)
    soft = np.where(channel.encode_batch(bits) != 0, 255, 0).astype(np.int32)
    for row in soft:
        at = rng.integers(0, row.size, flips)
        row[at] = 255 - row[at]
    return bits, TP.puncture(soft, mask).astype(np.int32)


@pytest.mark.parametrize("level,prof", [(lv, p) for p in "AB"
                                        for lv in (1, 2, 3, 4)])
def test_punctured_frames_match_jax_and_golden(level, prof):
    mask = TP.frame_mask(KBPS, level, prof)
    rng = np.random.default_rng(10 * level + (prof == "B"))
    _, rec = _punctured(rng, mask, 24 * KBPS)
    want = np.asarray(JD.decode_punctured_frames(rec, KBPS, level, prof))
    got = TD.decode_punctured_frames(rec, KBPS, level, prof, device="cpu")
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    full = TP.depuncture(rec, mask)
    assert np.array_equal(got.numpy(), TG.deconvolve_many(24 * KBPS, full))


def test_depuncture_device_matches():
    mask = TP.frame_mask(KBPS, 3, "A")
    rec = np.random.default_rng(0).integers(0, 256, (2, int(mask.sum())))
    got = TD.depuncture_device(torch.from_numpy(rec), mask)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(JD.depuncture_device(rec, mask)))
    assert np.array_equal(got.numpy(), TP.depuncture(rec, mask))


def test_profile_frames_match_jax_with_a_user_row():
    row = ((6, 24), (10, 16), (5, 9), (3, 5))
    prof = TP.uep_profile_from_row(KBPS, 3, row)
    jprof = JP.uep_profile_from_row(KBPS, 3, row)
    rng = np.random.default_rng(6)
    bits, rec = _punctured(rng, prof.mask(), prof.data_bits, flips=10)
    want = np.asarray(JD.decode_profile_frames(rec, jprof))
    got = TD.decode_profile_frames(rec, prof, device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.packbits(bits, axis=1))
    with pytest.raises(ValueError, match="received must be"):
        TD.decode_profile_frames(rec[:, :-1], prof, device="cpu")
