"""The port's test-and-benchmark harness against the JAX package's on a
few tiny frames: the BER/FER gate on every rung, the Eb/N0 sweep, the
tuner's write-back and its consensus rule, and fault injection."""

import functools
import json

import pytest

import viterbi_tpu
import viterbi_tpu.harness.benchmark as jax_bench
import viterbi_tpu.harness.channel as jax_channel
import viterbi_tpu_torch
import viterbi_tpu_torch.harness.channel as channel
from viterbi_tpu.runtime import config as jax_config
from viterbi_tpu_torch.harness import benchmark
from viterbi_tpu_torch.runtime import config as config_mod
from viterbi_tpu_torch.runtime import dispatch

FRAMEBITS = 48


@pytest.fixture(autouse=True)
def _configs(tmp_path, monkeypatch):
    """Temporary config files for both packages; the JAX package runs its
    Pallas rungs in interpret mode; the port reports its kernels as built,
    so all four rungs are offered (they run as their plain versions)."""
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    jax_cfg = tmp_path / "jax.txt"
    jax_cfg.write_text("a:0\ninterpret=1\ncompile_cache=0\n")
    monkeypatch.setenv(jax_config.CONFIG_ENV, str(jax_cfg))
    real = dispatch.get_caps
    monkeypatch.setattr(dispatch, "get_caps",
                        lambda root=None: real(root) | dispatch.CAP_KERNELS)
    viterbi_tpu.initialize()
    viterbi_tpu_torch.initialize()
    yield
    # leave both dispatchers in their automatic state for later tests
    monkeypatch.setattr(dispatch, "get_caps", real)
    jax_cfg.write_text("a:0\ncompile_cache=0\n")
    viterbi_tpu.initialize()
    viterbi_tpu_torch.initialize()


@pytest.fixture
def noisy(monkeypatch):
    """Both channels at 0.5 dB, so a few tiny frames carry bit errors."""
    for mod in (channel, jax_channel):
        monkeypatch.setattr(mod, "make_frames", functools.partial(
            mod.make_frames, ebn0_db=0.5))


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_ber_fer_matches_jax_on_every_rung(variant, noisy):
    want = jax_bench.ber_fer_test(variant, 12, framebits=FRAMEBITS, batch=4)
    assert viterbi_tpu.runtime.dispatch.state().variant == variant
    got = benchmark.ber_fer_test(variant, 12, framebits=FRAMEBITS, batch=4)
    assert dispatch.state().variant == variant
    assert got == want
    assert got[2] > 0 and got[3] > 0     # the gate sees real errors


def test_ebno_sweep_matches_jax():
    kw = dict(points=(0.0, 1.0), frames=5, framebits=FRAMEBITS, seed=3)
    config_mod.write_variant(1)
    viterbi_tpu_torch.initialize()
    want = jax_bench.ebno_sweep(**kw)
    got = benchmark.ebno_sweep(**kw)
    assert got == want and got["ok"]
    assert got["points"]["0.0"]["bit_errors"] > 0


def test_main_gates_and_tunes(tmp_path, monkeypatch, capsys):
    """The whole harness at a tiny size: every rung agrees, the tuner
    writes its choice into byte 0 of the config, and the report says so."""
    monkeypatch.setattr(benchmark, "GATE_FRAMEBITS", 24)
    monkeypatch.setattr(benchmark, "SPEED_BATCH", 2)
    monkeypatch.setattr(benchmark, "SPEED_BITRATES", (1, 2))
    monkeypatch.setattr(benchmark, "SWEEP_FRAMES", 4)
    out = tmp_path / "report.json"
    report = benchmark.main(["/f", "100", "/t", "10", "/json", str(out)])
    assert json.loads(out.read_text()) == report
    assert sorted(report["variants"]) == sorted(dispatch.VARIANTS[:4])
    assert report["parity_ok"] and report["ebno_sweep"]["ok"]
    assert report["fault_injection"] == "PASS" and report["ok"]
    assert report["tuner_basis"] == "api_path"       # no card here
    for rec in report["variants"].values():
        assert set(rec["seconds_per_loop"]) == {"1", "2"}
        assert "device_gsym_s" not in rec
    chosen = dispatch.VARIANTS.index(report["chosen_variant"])
    assert config_mod.load().variant_override == chosen
    assert dispatch.state().variant == chosen
    assert "Updating config to variant" in capsys.readouterr().out


def test_a_device_failure_fails_the_report(monkeypatch):
    """On a card, a variant whose device-resident run raises loses the
    tune and turns the report's ok (the CLI's exit code) false."""
    monkeypatch.setattr(benchmark, "GATE_FRAMEBITS", 24)
    monkeypatch.setattr(benchmark, "SPEED_BATCH", 2)
    monkeypatch.setattr(benchmark, "SPEED_BITRATES", (1, 2))
    monkeypatch.setattr(benchmark, "SWEEP_FRAMES", 4)
    monkeypatch.setattr(benchmark, "_on_card", lambda: True)

    def device_speed_test(variant, *args):
        if dispatch.VARIANTS[variant] == "cuda_fused":
            raise RuntimeError("kernel launch failed")
        return 1e9 * (variant + 1)

    monkeypatch.setattr(benchmark, "device_speed_test", device_speed_test)
    report = benchmark.main(["/f", "100", "/t", "10", "/not"])
    assert report["parity_ok"] and report["ebno_sweep"]["ok"]
    assert not report["device_ok"] and not report["ok"]
    assert "kernel launch failed" in \
        report["variants"]["cuda_fused"]["device_error"]
    assert report["tuner_basis"] == "device_resident"
    assert report["chosen_variant"] == "cuda_words"


def test_tuner_takes_the_fastest_consensus_variant():
    def rec(errs, bad):
        return {"bit_errors": errs, "bad_frames": bad}

    report = {"variants": {
        "torch_scan": rec(5, 2), "torch_blocked": rec(5, 2),
        "cuda_words": rec(9, 3), "cuda_fused": rec(5, 2)}}
    rates = {"torch_scan": 1.0, "torch_blocked": 2.0, "cuda_words": 9.0,
             "cuda_fused": 4.0}
    # cuda_words is fastest but disagrees with the consensus
    assert benchmark._tune(report, [0, 1, 2, 3], rates) == 3
    # a variant whose device timing failed (rate 0) never wins
    rates["cuda_fused"] = 0.0
    assert benchmark._tune(report, [0, 1, 2, 3], rates) == 1
    # the consensus is the majority, even against variant 0
    report["variants"]["torch_scan"] = rec(7, 2)
    rates["cuda_fused"] = 4.0
    assert benchmark._tune(report, [0, 1, 2, 3], rates) == 3


def test_fault_injection_passes_and_rearms():
    assert benchmark.fault_injection_test()
    assert not dispatch.state().safe_mode


def test_fault_injection_covers_the_rs_export(monkeypatch):
    """Part (c): a null superframe buffer must return -1 and latch, as in
    the JAX package's harness; an export that shrugs it off fails."""
    assert jax_bench.fault_injection_test()
    monkeypatch.setattr(benchmark.api, "rs_check_superframe",
                        lambda *args: 0)
    assert not benchmark.fault_injection_test()
    assert not dispatch.state().safe_mode


def test_device_speed_test_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA device"):
        benchmark.device_speed_test(1, loops=1, batch=2, framebits=24)


def test_environment_report_names_the_device():
    rep = benchmark.environment_report()
    assert "device: cpu" in rep and "'torch_blocked'" in rep
    assert f"caps: 0x{dispatch.state().caps:x}" in rep


def test_selecting_an_unsupported_rung_raises(monkeypatch):
    monkeypatch.setattr(dispatch, "get_caps", lambda root=None:
                        dispatch.CAP_TORCH | dispatch.CAP_BLOCKED_TB)
    with pytest.raises(RuntimeError, match="not supported"):
        benchmark.ber_fer_test(2, 4, framebits=FRAMEBITS, batch=4)
