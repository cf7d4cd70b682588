"""Public API of the port against the JAX package's on the same frames,
plus the port's dispatch, config, fault-latch and call-log contracts."""

import numpy as np
import pytest

import viterbi_tpu
import viterbi_tpu_torch
from viterbi_tpu.harness import channel
from viterbi_tpu.runtime import config as jax_config
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.runtime import config as config_mod
from viterbi_tpu_torch.runtime import dispatch


@pytest.fixture(autouse=True)
def _fresh_config(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    jax_cfg = tmp_path / "jax.txt"
    jax_cfg.write_text("a:0\ncompile_cache=0\n")   # leave jax's cache alone
    monkeypatch.setenv(jax_config.CONFIG_ENV, str(jax_cfg))
    viterbi_tpu.initialize()
    viterbi_tpu_torch.initialize()
    yield
    viterbi_tpu_torch.initialize()


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Select the cuda_fused rung on a CPU-only host: its kernels then
    run as their plain versions (the dispatcher never picks it here)."""
    monkeypatch.setattr(dispatch.state(), "variant",
                        dispatch.VARIANTS.index("cuda_fused"))


def _syms(framebits, n=3):
    _, syms = channel.make_frames(n, framebits, seed=framebits)
    return syms


@pytest.mark.parametrize("framebits", [1, 13, 100, 96, 192])
def test_deconvolve_batch_matches_jax(framebits):
    syms = _syms(framebits)
    r1, want = viterbi_tpu.deconvolve_batch(framebits, syms)
    r2, got = viterbi_tpu_torch.deconvolve_batch(framebits, syms)
    assert r1 == r2 == 0
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("framebits", [96, 192])
def test_deconvolve_batch_fused_matches_jax(framebits, fused_on_cpu):
    syms = _syms(framebits)
    _, want = viterbi_tpu.deconvolve_batch(framebits, syms)
    assert viterbi_tpu_torch.deconvolve_batch(framebits, syms)[1].tobytes() \
        == want.tobytes()


@pytest.mark.parametrize("rung", ["torch_scan", "cuda_fused"])
@pytest.mark.parametrize("framebits", [13, 96])
def test_deconvolve_batch_packed_matches_jax(framebits, rung):
    syms = _syms(framebits)
    packed = acs_cuda.pack_symbols_host(syms)
    _, want = viterbi_tpu.deconvolve_batch(framebits, packed, packed=True)
    dispatch.state().variant = dispatch.VARIANTS.index(rung)
    ret, got = viterbi_tpu_torch.deconvolve_batch(framebits, packed,
                                                  packed=True)
    assert ret == 0 and np.array_equal(got, want)
    # short packed buffer: validation error, no latch
    assert viterbi_tpu_torch.deconvolve_batch(
        framebits, packed[:, :10], packed=True) == (1, None)
    assert not dispatch.state().safe_mode


@pytest.mark.parametrize("framebits", [13, 96])
def test_deconvolve_matches_jax(framebits):
    syms = _syms(framebits, n=1)[0]
    out1 = np.zeros(-(-framebits // 8), np.uint8)
    out2 = np.zeros(-(-framebits // 8), np.uint8)
    assert viterbi_tpu.deconvolve(framebits, syms, 0, out1) == 0
    assert viterbi_tpu_torch.deconvolve(framebits, syms, 0, out2) == 0
    assert np.array_equal(out1, out2)
    assert np.array_equal(viterbi_tpu_torch.last_output(), out1)
    buf = bytearray(out1.size)     # plain byte buffers take the bytes too
    assert viterbi_tpu_torch.deconvolve(framebits, syms, 0, buf) == 0
    assert bytes(buf) == out1.tobytes()


def test_fault_latch_and_rearm():
    framebits = 96
    syms = _syms(framebits, n=1)[0]
    assert viterbi_tpu_torch.deconvolve(0, None, 0, None) == 1   # "crash"
    assert dispatch.state().safe_mode
    assert viterbi_tpu_torch.deconvolve(framebits, syms) == 1    # latched
    assert viterbi_tpu_torch.deconvolve_batch(framebits, syms[None]) \
        == (1, None)
    viterbi_tpu_torch.initialize()
    assert not dispatch.state().safe_mode
    assert viterbi_tpu_torch.deconvolve(framebits, syms) == 0
    assert viterbi_tpu_torch.deconvolve_batch(framebits, None) == (1, None)
    assert dispatch.state().safe_mode


def test_kernel_fault_latches(monkeypatch, fused_on_cpu):
    """An exception inside the decode path latches safe mode."""
    def boom(*a, **k):
        raise RuntimeError("injected kernel fault")
    monkeypatch.setattr(acs_cuda, "forward_regs", boom)
    syms = _syms(96, n=1)
    assert viterbi_tpu_torch.deconvolve_batch(96, syms) == (1, None)
    assert dispatch.state().safe_mode


def test_validation_error_does_not_latch():
    framebits = 96
    syms = _syms(framebits, n=1)[0]
    assert viterbi_tpu_torch.deconvolve(9217, syms) == 1
    assert viterbi_tpu_torch.deconvolve(framebits, syms[:10]) == 1
    assert viterbi_tpu_torch.deconvolve(framebits, syms, 0,
                                        np.zeros(3, np.uint8)) == 1
    assert viterbi_tpu_torch.deconvolve_batch(framebits, syms[:10]) \
        == (1, None)
    assert not dispatch.state().safe_mode
    assert viterbi_tpu_torch.deconvolve(framebits, syms) == 0


def test_config_downgrade_and_upgrade_rules():
    st = dispatch.state()
    auto = st.variant
    assert dispatch.VARIANTS[auto] == "torch_scan"     # no CUDA device here
    assert st.caps & dispatch.CAP_TORCH
    assert not st.caps & (dispatch.CAP_CUDA | dispatch.CAP_KERNELS)
    for forced in (0, 1, 2, 3, 4):
        config_mod.write_variant(forced)
        viterbi_tpu_torch.initialize()
        # only torch_scan is supported here; everything else keeps auto
        assert st.variant == (0 if forced == 0 else auto)
    # with the kernels built, cuda_fused is best and a downgrade holds
    caps = dispatch.CAP_TORCH | dispatch.CAP_CUDA | dispatch.CAP_KERNELS
    assert dispatch.VARIANTS[dispatch._best_variant(caps)] == "cuda_fused"
    assert dispatch._variant_supported(0, caps)
    assert not dispatch._variant_supported(1, caps)   # not ported yet
    assert not dispatch._variant_supported(2, caps)


def test_config_banner_and_template(tmp_path, capsys):
    path = tmp_path / "banner.txt"
    cfg = config_mod.load(str(path))
    assert cfg.variant_override == -1 and not cfg.show_info
    text = path.read_text()
    assert text.startswith("a:0\n")
    path.write_text("0:1" + text[3:])
    viterbi_tpu_torch.initialize(str(path))
    assert "variant=torch_scan" in capsys.readouterr().out
    assert dispatch.state().config.path == str(path)


def test_config_keys(tmp_path):
    p = tmp_path / "keys.txt"
    p.write_text("a:0\ncompile_cache=/somewhere/kernels\nlog_calls=1\n"
                 "unknown_key=5\n")
    cfg = config_mod.load(str(p))
    assert cfg.compile_cache == "/somewhere/kernels" and cfg.log_calls
    p.write_text("a:0\ncompile_cache=0\n")
    assert config_mod.load(str(p)).compile_cache \
        == config_mod.Config().compile_cache


def test_config_env_var_separates_the_packages(tmp_path):
    """Each package's tuner writes its own file."""
    config_mod.write_variant(0)
    jax_config.write_variant(1)
    assert config_mod.load().variant_override == 0
    assert jax_config.load().variant_override == 1
    assert config_mod.default_path() != jax_config.default_path()


def test_wake_up_ladder():
    viterbi_tpu_torch.wake_up(batch=2, ladder=(8, 32))
    viterbi_tpu_torch.wake_up(framebits=48, ladder=())
    with pytest.raises(TypeError, match="iterable of kbit/s"):
        viterbi_tpu_torch.wake_up(ladder=0)


def test_get_caps_on_cpu():
    assert viterbi_tpu_torch.get_caps() == dispatch.CAP_TORCH


def test_calllog_and_symbol_capture(tmp_path):
    from viterbi_tpu_torch.runtime import calllog
    base = str(tmp_path / "log" / "trace")
    calllog.configure(True, True, base)
    framebits = 48
    syms = golden.hard_to_soft(golden.encode(
        np.random.default_rng(1).integers(0, 2, framebits, dtype=np.uint8)))
    try:
        assert viterbi_tpu_torch.deconvolve(framebits, syms) == 0
        assert viterbi_tpu_torch.deconvolve(framebits, syms) == 0
        s = calllog.summary()
        assert s["calls"] == 2 and s["stats"]["deco"]["count"] == 2
        assert s["stats"]["deco"]["distinct_buffers"] == 1
    finally:
        calllog.configure(False)
    log = open(base + ".log").read()
    assert "deco" in log and "framebits=48" in log and "summary" in log
    caps = sorted((tmp_path / "log" / "trace_sym").glob("*.npy"))
    assert len(caps) == 2
    assert np.array_equal(np.load(caps[0]), syms[:4 * (framebits + 6)])


def test_calllog_profiler_spans(tmp_path):
    from viterbi_tpu_torch.runtime import calllog
    prof_dir = tmp_path / "prof"
    calllog.configure(True, False, str(tmp_path / "p"),
                      profile_dir=str(prof_dir))
    try:
        assert viterbi_tpu_torch.deconvolve(48, _syms(48, n=1)[0]) == 0
    finally:
        calllog.configure(False)
    trace = (prof_dir / "trace.json").read_text()
    assert "viterbi_tpu_torch.deco" in trace
