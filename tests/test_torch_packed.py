"""Packed symbol words through every rung of the port: the words go to the
decode device as they are wherever framebits % 8 == 0, and every rung
returns what it returns for unpacked symbols, what the golden model
returns and what the JAX package's ``deconvolve_batch(packed=True)``
returns on the same seeded frames. Tolerance zero."""

import numpy as np
import pytest
import torch

import viterbi_tpu
import viterbi_tpu_torch
from viterbi_tpu.harness import channel
from viterbi_tpu.runtime import config as jax_config
from viterbi_tpu_torch import api, golden
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.runtime import config as config_mod
from viterbi_tpu_torch.runtime import dispatch

RUNGS = ("torch_scan", "torch_blocked", "cuda_words", "cuda_fused")
# 192 and 768 lie on the 24-bit window grid, 64 off it (cuda_words then
# takes the blocked traceback)
FRAMEBITS = (192, 768, 64)


@pytest.fixture(autouse=True)
def _fresh_config(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    jax_cfg = tmp_path / "jax.txt"
    jax_cfg.write_text("a:0\ncompile_cache=0\n")   # leave jax's cache alone
    monkeypatch.setenv(jax_config.CONFIG_ENV, str(jax_cfg))
    viterbi_tpu.initialize()
    viterbi_tpu_torch.initialize(device="cpu")
    yield
    viterbi_tpu_torch.initialize()


def _select(rung):
    """The rung by name, as on a host whose kernels are built: on the CPU
    its kernels run as their plain versions."""
    dispatch.state().variant = dispatch.VARIANTS.index(rung)


def _frames(framebits, n=3):
    _, syms = channel.make_frames(n, framebits, seed=framebits + 11)
    return syms


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("framebits", FRAMEBITS)
def test_packed_call_equals_unpacked_golden_and_jax(framebits, rung):
    syms = _frames(framebits)
    packed = acs_cuda.pack_symbols_host(syms)
    r_jax, want = viterbi_tpu.deconvolve_batch(framebits, packed, packed=True)
    _select(rung)
    r_p, got = viterbi_tpu_torch.deconvolve_batch(framebits, packed,
                                                  packed=True)
    r_u, unpacked = viterbi_tpu_torch.deconvolve_batch(framebits, syms)
    assert r_jax == r_p == r_u == 0
    assert got.dtype == np.uint8 and got.shape == (3, framebits // 8)
    assert np.array_equal(got, unpacked)
    assert np.array_equal(got, golden.deconvolve_many(framebits, syms))
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("framebits", FRAMEBITS)
def test_packed_words_reach_the_decode_as_they_are(framebits, rung,
                                                   monkeypatch):
    """On the byte grid ``_decode_batch`` builds no unpacked host array:
    the tensor it hands on has one int32 word a trellis step."""
    seen = []
    real = api._decode_tensor

    def spy(syms, fb, variant, packed=False):
        seen.append((tuple(syms.shape), syms.dtype, variant, packed))
        return real(syms, fb, variant, packed)

    monkeypatch.setattr(api, "_decode_tensor", spy)
    packed = acs_cuda.pack_symbols_host(_frames(framebits))
    _select(rung)
    assert viterbi_tpu_torch.deconvolve_batch(framebits, packed,
                                              packed=True)[0] == 0
    assert seen == [((3, framebits + 6), torch.int32, rung, True)]


@pytest.mark.parametrize("rung", RUNGS)
def test_packed_words_off_the_byte_grid_take_the_host_byte_view(
        rung, monkeypatch):
    """framebits % 8 != 0 decodes through the plain path at any framebits,
    which reads unpacked symbols: the byte view of the words, as in the JAX
    package."""
    framebits = 13
    seen = []
    real = api._decode_tensor

    def spy(syms, fb, variant, packed=False):
        seen.append((tuple(syms.shape), packed))
        return real(syms, fb, variant, packed)

    monkeypatch.setattr(api, "_decode_tensor", spy)
    syms = _frames(framebits)
    packed = acs_cuda.pack_symbols_host(syms)
    _, want = viterbi_tpu.deconvolve_batch(framebits, packed, packed=True)
    _select(rung)
    ret, got = viterbi_tpu_torch.deconvolve_batch(framebits, packed,
                                                  packed=True)
    assert ret == 0 and np.array_equal(got, np.asarray(want))
    assert seen == [((3, 4 * (framebits + 6)), False)]


def test_decode_tensor_refuses_packed_words_off_the_byte_grid():
    words = torch.zeros((2, 19), dtype=torch.int32)
    with pytest.raises(ValueError, match="byte grid"):
        api._decode_tensor(words, 13, "torch_blocked", packed=True)
