"""The port's tail-biting decode against the JAX package's and the golden
model, bit for bit: the numpy golden third (``encode_tailbiting``,
``_acs_pass``, ``tailbiting_decode``), the plain form against the JAX
XLA form, and the kernel form (run here through the kernels' plain
versions) against the JAX Pallas form in interpret mode. The cases of
``tests/test_tailbiting.py``, the end-metric tie fixture, forced ties and
the frame sizes at the edges; on the card (marker ``cuda``) the kernel
form against the plain form."""

import os

import numpy as np
import pytest
import torch

import viterbi_tpu_torch.golden as TG
from viterbi_tpu_torch.ops import _build
from viterbi_tpu_torch.ops import acs, acs_cuda
from viterbi_tpu_torch.ops import tailbiting as TT
from viterbi_tpu_torch.ops import traceback as tb

TIE_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                           "tb_tie_syms.npy")


def _jax():
    """The JAX package's side, imported by the tests that compare with it:
    the card's machine has no JAX and runs only this file's card tests."""
    import jax.numpy as jnp

    import viterbi_tpu.golden as JG
    import viterbi_tpu.ops.tailbiting as JT
    return jnp, JG, JT


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda", 0)


def _frames(seed, B, framebits, wrap, nflips):
    """Noisy tail-biting frames (random symbol values at ``nflips``
    positions) and their golden decodes."""
    rng = np.random.default_rng(seed)
    syms = np.empty((B, 4 * framebits), np.int32)
    want = []
    for i in range(B):
        bits = rng.integers(0, 2, framebits).astype(np.uint8)
        soft = TG.hard_to_soft(TG.encode_tailbiting(bits)).astype(np.int32)
        flips = rng.choice(soft.size, nflips, replace=False)
        soft[flips] = rng.integers(0, 256, nflips)
        syms[i] = soft
        want.append(TG.tailbiting_decode(framebits, soft, wrap_steps=wrap))
    return syms, np.stack(want)


@pytest.mark.parametrize("framebits,wrap", [(8, 8), (13, 4), (50, 48),
                                            (192, 96), (192, 0)])
def test_golden_tailbiting_matches_jax(framebits, wrap):
    jnp, JG, JT = _jax()
    rng = np.random.default_rng(framebits)
    bits = rng.integers(0, 2, framebits).astype(np.uint8)
    hard = TG.encode_tailbiting(bits)
    assert hard.dtype == np.uint8
    assert np.array_equal(hard, JG.encode_tailbiting(bits))
    soft = TG.hard_to_soft(hard).astype(np.int32)
    flips = rng.choice(soft.size, framebits // 2, replace=False)
    soft[flips] = rng.integers(0, 256, flips.size)
    m0 = rng.integers(0, 200, 64).astype(np.int32)
    d1 = np.zeros((framebits, 64), np.uint8)
    d2 = np.zeros((framebits, 64), np.uint8)
    # an odd start and a pass that wraps around the frame
    m1 = JG._acs_pass(m0, soft, framebits - 3, framebits, d1)
    m2 = TG._acs_pass(m0, soft, framebits - 3, framebits, d2)
    assert np.array_equal(m1, m2) and np.array_equal(d1, d2)
    assert np.array_equal(TG.tailbiting_decode(framebits, soft, wrap),
                          JG.tailbiting_decode(framebits, soft, wrap))


def test_golden_loopback_noiseless():
    framebits = 192
    rng = np.random.default_rng(0)
    for _ in range(4):
        bits = rng.integers(0, 2, framebits).astype(np.uint8)
        soft = TG.hard_to_soft(TG.encode_tailbiting(bits))
        out = TG.tailbiting_decode(framebits, soft, wrap_steps=96)
        assert (out == np.packbits(bits)).all()


def test_golden_loopback_light_noise():
    """A few flipped symbols still decode exactly (free distance)."""
    framebits = 384
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, framebits).astype(np.uint8)
    soft = TG.hard_to_soft(TG.encode_tailbiting(bits)).astype(np.int32)
    flips = rng.choice(soft.size, 8, replace=False)
    soft[flips] = 255 - soft[flips]
    out = TG.tailbiting_decode(framebits, soft, wrap_steps=96)
    assert (out == np.packbits(bits)).all()


def test_plain_form_matches_jax_xla_and_golden():
    """test_tailbiting.py::test_jax_matches_golden's frames."""
    jnp, JG, JT = _jax()
    framebits, wrap = 192, 48
    syms, want = _frames(2, 6, framebits, wrap, 40)
    got = TT.decode_tailbiting(syms, framebits, wrap_steps=wrap,
                               device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    jax_out = np.asarray(JT.decode_tailbiting(jnp.asarray(syms), framebits,
                                              wrap_steps=wrap))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(jax_out, want)


def test_kernel_form_matches_jax_pallas_and_golden():
    """test_tailbiting.py::test_pallas_matches_xla's frames: kernels C, A
    and B as their plain versions against the JAX register-exchange form
    in interpret mode."""
    jnp, JG, JT = _jax()
    framebits, wrap = 192, 48
    syms, want = _frames(5, 4, framebits, wrap, 30)
    got = TT.decode_kernels(torch.from_numpy(syms), framebits, wrap)
    jax_out = np.asarray(JT.decode_tailbiting(
        jnp.asarray(syms), framebits, wrap_steps=wrap, use_pallas=True,
        interpret=True))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(jax_out, want)


def test_tie_fixture_both_forms():
    """The frame whose two best end states tie with a circularly
    inconsistent best path: both forms equal golden and the JAX forms."""
    jnp, JG, JT = _jax()
    framebits = 768
    syms = np.load(TIE_FIXTURE)[None]
    want = TG.tailbiting_decode(framebits, syms[0], wrap_steps=96)
    assert np.array_equal(
        want, JG.tailbiting_decode(framebits, syms[0], wrap_steps=96))
    t = torch.from_numpy(syms)
    plain = TT.decode_tailbiting(t, framebits, 96)
    kern = TT.decode_kernels(t, framebits, 96)
    assert np.array_equal(plain.numpy()[0], want)
    assert np.array_equal(kern.numpy()[0], want)
    jax_x = np.asarray(JT.decode_tailbiting(jnp.asarray(syms), framebits,
                                            wrap_steps=96))
    assert np.array_equal(jax_x[0], want)


def _tie_frames(B, framebits, seed=7):
    """Symbols of 127 and 128 only: branch metrics one apart, so the end
    metrics tie in many frames."""
    rng = np.random.default_rng(seed)
    return (127 + rng.integers(0, 2, (B, 4 * framebits))).astype(np.int32)


def test_forced_end_metric_ties_take_the_lowest_state():
    framebits, wrap = 96, 48
    syms = _tie_frames(12, framebits)
    t = torch.from_numpy(syms)
    zero = torch.zeros((12, 64), dtype=torch.int32)
    _, m = acs.forward(t[:, 4 * (framebits - wrap):], wrap, zero)
    _, m = acs.forward(t, framebits, m)
    ties = (m == m.min(dim=1, keepdim=True).values).sum(dim=1)
    assert (ties > 1).sum() >= 6, "the fixture must force ties"
    assert np.array_equal(tb.best_state(m).numpy(),
                          np.argmin(m.numpy(), axis=1))
    want = np.stack([TG.tailbiting_decode(framebits, s, wrap) for s in syms])
    assert np.array_equal(TT.decode_tailbiting(t, framebits, wrap).numpy(),
                          want)
    assert np.array_equal(TT.decode_kernels(t, framebits, wrap).numpy(), want)


@pytest.mark.parametrize("framebits,wrap", [(8, 8), (32, 32), (48, 0),
                                            (1536, 96)])
def test_frame_sizes_both_forms(framebits, wrap):
    """The smallest frames (one checkpoint; 32 takes checkpoint 16),
    no warm-up, and a frame above the walk's 24-bit period."""
    syms, want = _frames(framebits, 3, framebits, wrap,
                         min(40, framebits))
    t = torch.from_numpy(syms)
    assert np.array_equal(TT.decode_tailbiting(t, framebits, wrap).numpy(),
                          want)
    assert np.array_equal(TT.decode_kernels(t, framebits, wrap).numpy(), want)


def test_validation():
    syms = np.zeros((2, 4 * 48), np.int32)
    with pytest.raises(AssertionError):
        TT.decode_tailbiting(syms, 48, wrap_steps=7, device="cpu")
    with pytest.raises(AssertionError):
        TT.decode_tailbiting(syms, 48, wrap_steps=50, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        TT.decode_tailbiting(syms, 48, 48, use_kernels=True, device="cpu")
    with pytest.raises(ValueError, match="framebits % 8"):
        TT.decode_kernels(torch.zeros((2, 4 * 50), dtype=torch.int32), 50, 8)
    with pytest.raises(ValueError, match="symbols must be"):
        TT.decode_tailbiting(syms[:, :100], 48, 48, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("framebits,wrap", [(8, 8), (32, 32), (768, 96),
                                            (3072, 96)])
def test_card_kernel_form_matches_plain(cuda, framebits, wrap):
    """On the card: kernels C, A and B, one launch each, against the plain
    form on the card and against golden on a few frames."""
    syms, want = _frames(11, 4, framebits, wrap, min(40, framebits))
    syms = np.concatenate([syms, _tie_frames(60, framebits)])
    t = torch.from_numpy(syms).to(cuda)
    launches = (_build.ACS_WORDS.launches, _build.ACS_REGS.launches,
                _build.TB_WALK.launches)
    got = TT.decode_tailbiting(t, framebits, wrap)
    assert (_build.ACS_WORDS.launches - launches[0],
            _build.ACS_REGS.launches - launches[1],
            _build.TB_WALK.launches - launches[2]) == (1, 1, 1)
    plain = TT.decode_tailbiting(t, framebits, wrap, use_kernels=False)
    assert torch.equal(got, plain)
    assert np.array_equal(got[:4].cpu().numpy(), want)
