"""The port's numpy layer (constants, golden model, channel) against the
JAX package's, and the rule that the port never imports jax."""

import ast
from pathlib import Path

import numpy as np
import pytest

import viterbi_tpu.constants as JC
import viterbi_tpu.golden as JG
import viterbi_tpu.harness.channel as JCH
import viterbi_tpu_torch.constants as TC
import viterbi_tpu_torch.golden as TG
import viterbi_tpu_torch.harness.channel as TCH

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", [
    "K", "NUM_STATES", "RATE", "POLYS", "TAIL_BITS", "MAX_FRAMEBITS",
    "RENORMALIZE_THRESHOLD", "RENORM_SUB", "METRIC_MAX", "RS_NN",
    "RS_GFPOLY", "RS_NROOTS", "RS_PAD", "RS_N", "RS_KK", "ATO_MOD_SIZE"])
def test_scalar_constants_match(name):
    assert getattr(TC, name) == getattr(JC, name)


@pytest.mark.parametrize("table", [
    "branch_polarity_table", "expected_symbols_table", "gf256_tables",
    "gf256_mul_table"])
def test_constant_tables_match(table):
    want = getattr(JC, table)()
    got = getattr(TC, table)()
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_mod255_matches():
    x = np.arange(0, 66299)
    assert np.array_equal(TC.mod255(x), JC.mod255(x))


@pytest.mark.parametrize("framebits", [1, 13, 48, 96])
def test_golden_matches(framebits):
    bits, syms = JCH.make_frames(2, framebits, seed=framebits)
    for b, s in zip(bits, syms):
        assert np.array_equal(TG.encode(b), JG.encode(b))
        assert np.array_equal(TG.hard_to_soft(TG.encode(b)),
                              JG.hard_to_soft(JG.encode(b)))
        assert np.array_equal(TG.branch_metrics(s[:4]),
                              JG.branch_metrics(s[:4]))
        d1, m1 = JG.viterbi_forward(framebits, s)
        d2, m2 = TG.viterbi_forward(framebits, s)
        assert np.array_equal(d1, d2) and np.array_equal(m1, m2)
        assert np.array_equal(TG.chainback(framebits, d2),
                              JG.chainback(framebits, d1))
        assert np.array_equal(TG.deconvolve(framebits, s),
                              JG.deconvolve(framebits, s))


@pytest.mark.parametrize("nframes,framebits,seed",
                         [(3, 96, 0), (5, 8, 7), (40, 768, 3), (2, 1, 1),
                          (7, 13, 2)])
def test_make_frames_matches(nframes, framebits, seed):
    b1, s1 = JCH.make_frames(nframes, framebits, seed=seed)
    b2, s2 = TCH.make_frames(nframes, framebits, seed=seed)
    assert b1.dtype == b2.dtype and np.array_equal(b1, b2)
    assert s1.dtype == s2.dtype and np.array_equal(s1, s2)


def test_make_frames_noise_chunking_keeps_the_draw_order(monkeypatch):
    """Frames drawn in several noise chunks equal one-frame-at-a-time
    draws (the JAX package's order)."""
    monkeypatch.setattr(TCH, "_NOISE_CHUNK_SYMBOLS", 1000)
    b1, s1 = JCH.make_frames(9, 96, seed=5, ebn0_db=2.0)
    b2, s2 = TCH.make_frames(9, 96, seed=5, ebn0_db=2.0)
    assert np.array_equal(b1, b2) and np.array_equal(s1, s2)


def test_encode_batch_matches_golden():
    bits = np.random.default_rng(4).integers(0, 2, (6, 50), dtype=np.uint8)
    want = np.stack([JG.encode(b) for b in bits])
    assert np.array_equal(TCH.encode_batch(bits), want)


def test_ber_fer_matches():
    bits, syms = JCH.make_frames(6, 96, seed=11, ebn0_db=1.0)
    dec = np.stack([JG.deconvolve(96, s) for s in syms])
    assert TCH.ber_fer(dec, bits) == JCH.ber_fer(dec, bits)
    assert TCH.ber_fer(dec, bits)[2] > 0   # the check sees real errors


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "viterbi_tpu_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]))
def test_port_never_imports_jax(path):
    """The port runs where jax is absent: no file of the package (nor
    chip_smoke.py) imports jax or the JAX package."""
    for mod in _imported_modules(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "viterbi_tpu"), \
            f"{path} imports {mod}"
