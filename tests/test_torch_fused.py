"""Fused register-exchange path of the port (``ops.acs_cuda`` and the
checkpoint walk of ``ops.traceback``, on their plain versions here)
against the JAX package's Pallas kernels in interpret mode and the golden
model: bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viterbi_tpu import golden
from viterbi_tpu.harness import channel
from viterbi_tpu.ops import acs_pallas
from viterbi_tpu.ops import traceback as jax_tb
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.ops import traceback as tb


def _frames(framebits, seed, n=2):
    _, syms = channel.make_frames(n, framebits, seed=seed)
    return syms.astype(np.int32)


def _init(n, seed=1):
    return np.random.default_rng(seed).integers(0, 120, (n, 64)) \
        .astype(np.int32)


def _assert_regs_equal(jax_out, torch_out):
    (r1, m1), (r2, m2) = jax_out, torch_out
    assert r2.dtype == torch.int32 and m2.dtype == torch.int32
    assert np.array_equal(r2.numpy(), np.asarray(r1))
    assert np.array_equal(m2.numpy(), np.asarray(m1))


# 48/96/192: CG kernels (6 | ckpt); 64: _kernel_regs (nsteps 70, ckpt 14),
# which takes unpacked input only
@pytest.mark.parametrize("framebits,packed", [
    (48, False), (48, "bt"), (64, False), (96, False), (96, "bt"),
    (192, False), (192, "bt")])
def test_forward_regs_matches_jax(framebits, packed):
    nsteps = framebits + 6
    syms = _frames(framebits, seed=framebits)
    if packed:
        syms = acs_pallas.pack_symbols_host(syms)
    init = _init(2)
    want = acs_pallas.forward_regs(jnp.asarray(syms), nsteps,
                                   initial_metrics=jnp.asarray(init),
                                   packed=packed, interpret=True)
    got = acs_cuda.forward_regs(torch.from_numpy(syms), nsteps,
                                initial_metrics=torch.from_numpy(init),
                                packed=packed)
    _assert_regs_equal(want, got)


@pytest.mark.parametrize("framebits,packed,front_pad", [
    (96, "bt", 12), (192, False, 6), (48, True, 18)])
def test_forward_regs_front_pad_matches_jax(framebits, packed, front_pad):
    """The pad/reset contract: dead zero-symbol steps, then metrics and
    registers restart at reset_at; every checkpoint (pad region
    included) and the final metrics match."""
    nsteps = framebits + 6
    syms = _frames(framebits, seed=framebits + 5)
    if packed:
        syms = acs_pallas.pack_symbols_host(syms)
        if packed is True:
            syms = np.ascontiguousarray(syms.T)          # time-major
    want = acs_pallas.forward_regs(jnp.asarray(syms), nsteps,
                                   packed=packed, front_pad=front_pad,
                                   interpret=True)
    got = acs_cuda.forward_regs(torch.from_numpy(syms), nsteps,
                                packed=packed, front_pad=front_pad)
    _assert_regs_equal(want, got)


def test_forward_regs_matches_x6_geometry():
    """The 6-phase geometry computes the same function as kernel A."""
    framebits = 192
    syms = _frames(framebits, seed=23)
    init = _init(2, seed=4)
    want = acs_pallas.forward_regs(jnp.asarray(syms), framebits + 6,
                                   initial_metrics=jnp.asarray(init),
                                   interpret=True, geom="x6")
    got = acs_cuda.forward_regs(torch.from_numpy(syms), framebits + 6,
                                initial_metrics=torch.from_numpy(init))
    _assert_regs_equal(want, got)


# 264 -> nsteps 270: ckpt 18 by default, 10 (natural-order kernel) and 6
# by request; 176 -> nsteps 182: ckpt 26, assembled bit by bit
@pytest.mark.parametrize("framebits,ckpt", [(264, None), (264, 10),
                                            (264, 6), (176, None)])
def test_chainback_regs_cuda_matches_jax(framebits, ckpt):
    nsteps = framebits + 6
    syms = _frames(framebits, seed=5)
    regs, _ = acs_pallas.forward_regs(jnp.asarray(syms), nsteps, ckpt=ckpt,
                                      interpret=True)
    ck = ckpt or acs_pallas.choose_ckpt(nsteps)
    want = np.asarray(jax_tb.chainback_regs_pallas(regs, framebits,
                                                   ckpt=ck, interpret=True))
    assert np.array_equal(np.asarray(jax_tb.chainback_regs(
        regs, framebits, ckpt=ck)), want)
    tregs = torch.from_numpy(np.array(regs))
    assert np.array_equal(
        tb.chainback_regs_cuda(tregs, framebits, ckpt=ck).numpy(), want)
    assert np.array_equal(tb.chainback_regs(tregs, framebits, ckpt=ck)
                          .numpy(), want)


def test_chainback_regs_cuda_offset_matches_jax():
    framebits, pad = 96, 12
    nsteps = framebits + 6
    syms = acs_pallas.pack_symbols_host(_frames(framebits, seed=15))
    regs, _ = acs_pallas.forward_regs(jnp.asarray(syms), nsteps,
                                      packed="bt", front_pad=pad,
                                      interpret=True)
    ck = acs_pallas.choose_ckpt(nsteps + pad)
    want = np.asarray(jax_tb.chainback_regs_pallas(
        regs, framebits, ckpt=ck, interpret=True, offset=pad))
    got = tb.chainback_regs_cuda(torch.from_numpy(np.array(regs)),
                                 framebits, ckpt=ck, offset=pad)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.stack(
        [golden.deconvolve(framebits, s) for s in _frames(framebits, 15)]))


def test_chainback_regs_cuda_tailbiting_anchor_matches_jax():
    """tail=0 with per-frame anchors and the wrap_last6 fix-up."""
    framebits = 96
    rng = np.random.default_rng(6)
    syms = rng.integers(0, 256, (4, 4 * framebits)).astype(np.int32)
    regs, _ = acs_pallas.forward_regs(jnp.asarray(syms), framebits,
                                      ckpt=24, interpret=True)
    anchor = rng.integers(0, 64, 4).astype(np.int32)
    want = np.asarray(jax_tb.chainback_regs_pallas(
        regs, framebits, ckpt=24, tail=0, anchor=jnp.asarray(anchor),
        wrap_last6=True, interpret=True))
    got = tb.chainback_regs_cuda(torch.from_numpy(np.array(regs)),
                                 framebits, ckpt=24, tail=0,
                                 anchor=torch.from_numpy(anchor),
                                 wrap_last6=True)
    assert np.array_equal(got.numpy(), want)


def test_tb_walk_interior_anchor_matches_jax_rows():
    """anchor_k: rows at and below the injection index equal the JAX
    kernel's (rows above it are scratch the emit window never reads)."""
    rng = np.random.default_rng(9)
    K, B, ckpt = 7, 5, 24
    regs = rng.integers(-2**31, 2**31, (K, 64, B)).astype(np.int32)
    anchor = rng.integers(0, 64, B).astype(np.int32)
    anchor_k = rng.integers(0, K, B).astype(np.int32)
    want = np.asarray(jax_tb._run_tb_kernel(
        jnp.asarray(regs), K, ckpt, ckpt, jnp.asarray(anchor),
        jnp.asarray(anchor_k), 512, 3 * 2**20, True))
    got = tb.tb_walk(torch.from_numpy(regs), ckpt, ckpt,
                     torch.from_numpy(anchor),
                     torch.from_numpy(anchor_k)).numpy()
    for b in range(B):
        rows = slice(0, anchor_k[b] + 1)
        assert np.array_equal(got[rows, b], want[rows, b]), b


@pytest.mark.parametrize("framebits",
                         [8, 32, 40, 64, 96, 168, 224, 768, 3072])
def test_decode_matches_golden(framebits):
    syms = _frames(framebits, seed=framebits + 1)
    expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
    got = acs_cuda.decode(torch.from_numpy(syms), framebits)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), expect)
    packed = torch.from_numpy(acs_pallas.pack_symbols_host(syms))
    got = acs_cuda.decode(packed, framebits, packed="bt")
    assert np.array_equal(got.numpy(), expect)


@pytest.mark.parametrize("framebits", [32, 40])
def test_sizes_the_jax_fused_path_rejects(framebits):
    """The JAX fused decode asserts where choose_ckpt does not divide
    nsteps (443 of the byte-aligned sizes); the port decodes them with a
    partial last checkpoint."""
    syms = _frames(framebits, seed=2)
    with pytest.raises(AssertionError):
        acs_pallas.decode(jnp.asarray(syms), framebits, interpret=True)
    expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
    assert np.array_equal(
        acs_cuda.decode(torch.from_numpy(syms), framebits).numpy(), expect)


def test_choose_ckpt_matches_jax_where_it_divides():
    differ = 0
    for framebits in range(8, 9217, 8):
        n = framebits + 6
        ours, theirs = acs_cuda.choose_ckpt(n), acs_pallas.choose_ckpt(n)
        if n % theirs == 0:
            assert ours == theirs, framebits
        else:
            differ += 1
            assert ours == 24, framebits
    assert differ > 0


def test_pack_symbols_matches_jax():
    rng = np.random.default_rng(3)
    syms = rng.integers(0, 256, (3, 4 * 54), dtype=np.int32)
    want = np.asarray(acs_pallas.pack_symbols(jnp.asarray(syms), 54))
    assert np.array_equal(
        acs_cuda.pack_symbols(torch.from_numpy(syms), 54).numpy(), want)
    assert np.array_equal(acs_cuda.pack_symbols_host(syms),
                          acs_pallas.pack_symbols_host(syms))
