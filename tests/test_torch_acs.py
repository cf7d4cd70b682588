"""Plain-torch ACS forward (``viterbi_tpu_torch.ops.acs``) against the JAX
package's ``ops.acs.forward`` and the golden model: bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viterbi_tpu import golden
from viterbi_tpu.harness import channel
from viterbi_tpu.ops import acs as jax_acs
from viterbi_tpu_torch.ops import acs


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("framebits", [48, 96, 768])
def test_forward_matches_jax(framebits, with_init):
    nsteps = framebits + 6
    _, syms = channel.make_frames(3, framebits, seed=framebits)
    syms = syms.astype(np.int32)
    init = (np.random.default_rng(0).integers(0, 120, (3, 64))
            .astype(np.int32) if with_init else None)
    d1, m1 = jax_acs.forward(jnp.asarray(syms), nsteps,
                             None if init is None else jnp.asarray(init))
    d2, m2 = acs.forward(torch.from_numpy(syms), nsteps,
                         None if init is None else torch.from_numpy(init))
    assert d2.dtype == torch.int32 and d2.shape == (nsteps, 3, 2)
    assert np.array_equal(d2.numpy().view(np.uint32), np.asarray(d1))
    assert np.array_equal(m2.numpy(), np.asarray(m1))


def test_forward_decisions_match_golden():
    framebits = 96
    _, syms = channel.make_frames(2, framebits, seed=3)
    dec, met = acs.forward(torch.from_numpy(syms.astype(np.int32)),
                           framebits + 6)
    words = dec.numpy().view(np.uint32)
    for i, s in enumerate(syms):
        want, want_m = golden.viterbi_forward(framebits, s)
        bits = (words[:, i, np.arange(64) // 32]
                >> (np.arange(64) % 32)) & 1
        assert np.array_equal(bits, want)
        assert np.array_equal(met[i].numpy(), want_m)


def test_branch_metrics_match_golden():
    rng = np.random.default_rng(8)
    syms4 = rng.integers(0, 1 << 20, (50, 4))       # low byte significant
    got = acs.branch_metrics(torch.from_numpy(syms4)).numpy()
    want = np.stack([golden.branch_metrics(s) for s in syms4])
    assert np.array_equal(got, want)


def test_forward_rejects_odd_nsteps():
    with pytest.raises(AssertionError):
        acs.forward(torch.zeros((1, 4 * 7), dtype=torch.int32), 7)
