"""Capture and replay through the port: captured symbol streams decode
again to the golden model's bytes, and the committed corpus (``deco`` and
``rscs`` captures) replays bit-exactly, as it does through the JAX
package. Tolerance zero."""

import os

import numpy as np
import pytest

import viterbi_tpu
import viterbi_tpu.harness.replay as jax_replay
import viterbi_tpu_torch
from viterbi_tpu.runtime import config as jax_config
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import replay
from viterbi_tpu_torch.runtime import calllog
from viterbi_tpu_torch.runtime import config as config_mod

CORPUS = os.path.join(os.path.dirname(__file__), "data", "corpus")


@pytest.fixture(autouse=True)
def _fresh_config(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    jax_cfg = tmp_path / "jax.txt"
    jax_cfg.write_text("a:0\ncompile_cache=0\n")
    monkeypatch.setenv(jax_config.CONFIG_ENV, str(jax_cfg))
    viterbi_tpu.initialize()
    viterbi_tpu_torch.initialize()


def test_committed_corpus_replays_bit_exactly():
    n_ok, n_total, report = replay.replay_corpus(CORPUS)
    bad = [r for r in report if not r[2]]
    # 5 bitrates x 2 frames + 3 superframe cases
    assert n_total == 13 and n_ok == 13 and not bad, bad
    assert {r[1] for r in report} == {"deco", "rscs"}
    # the same verdicts, file for file, as the JAX package's replay
    assert (n_ok, n_total, report) == jax_replay.replay_corpus(CORPUS)


def test_corpus_holds_all_three_rs_outcomes():
    """The rscs captures cover a clean, a corrected and an uncorrectable
    superframe, so the replay exercises the -1 path too."""
    errors = {}
    for path, kind, _ in replay.iter_captures(CORPUS):
        if kind == "rscs":
            ex = np.load(path.removesuffix(".npy") + ".expect.npz")
            errors[os.path.basename(path)] = int(ex["errors"])
    assert len(errors) == 3
    assert 0 in errors.values() and -1 in errors.values()
    assert any(e > 0 for e in errors.values())


def test_capture_then_replay(tmp_path):
    base = str(tmp_path / "cap")
    calllog.configure(True, True, base)
    rng = np.random.default_rng(0)
    try:
        for framebits in (48, 96):
            bits = rng.integers(0, 2, framebits, dtype=np.uint8)
            syms = golden.hard_to_soft(golden.encode(bits))
            assert viterbi_tpu_torch.deconvolve(framebits, syms) == 0
    finally:
        calllog.configure(False)
    n_ok, n_total, report = replay.replay(base + "_sym")
    assert n_total == 2 and n_ok == 2, report
    assert [r[1] for r in report] == [48, 96]
    # captures of the port replay through the JAX package too
    assert jax_replay.replay(base + "_sym")[:2] == (2, 2)


def test_replay_reports_a_wrong_expectation(tmp_path):
    """A capture whose recorded output is wrong fails its replay."""
    syms = np.load(os.path.join(CORPUS, "008kbps0_deco.npy"))
    expect = np.load(os.path.join(CORPUS, "008kbps0_deco.expect.npy"))
    np.save(tmp_path / "x_deco.npy", syms)
    np.save(tmp_path / "x_deco.expect.npy", expect ^ 1)
    assert replay.replay_corpus(str(tmp_path)) == \
        (0, 1, [("x_deco.npy", "deco", False)])
    assert replay.infer_framebits(syms) == 8 * 24
