"""The port's scaling sweep (``harness.scaling``): the efficiency envelope
against the JAX package's function, the sweep's result schema against
the JAX sweep's at one and two spawned ranks on the CPU, its CLI and
``--json`` payload, and its refusal to run without a card unless asked
for the CPU. No wall-clock gate: the ranks share this host with the
other test workers, so a time here measures them, not the sweep."""

import json

import pytest
import torch

from viterbi_tpu_torch.harness import scaling

KEYS = {"mbit_s", "efficiency", "predicted_envelope"}


@pytest.mark.parametrize("n", range(1, 33))
def test_envelope_matches_jax(n):
    from viterbi_tpu.harness import scaling as JS
    assert scaling.predicted_efficiency_envelope(n) == \
        JS.predicted_efficiency_envelope(n)


def test_sweep_at_one_and_two_ranks_has_the_jax_schema():
    from viterbi_tpu.harness import scaling as JS
    jax_keys = {k for r in JS.sweep(frames_per_device=1, framebits=192,
                                    loops=1, repeats=1).values() for k in r}
    assert jax_keys == KEYS
    got = scaling.sweep(frames_per_device=2, framebits=48, loops=1,
                        repeats=1, max_ranks=2, device="cpu", timeout=120)
    assert list(got) == [1, 2]
    for n, r in got.items():
        assert set(r) == KEYS and r["mbit_s"] > 0
        lo, hi = scaling.predicted_efficiency_envelope(n)
        assert r["predicted_envelope"] == [round(lo, 3), hi]
    assert got[1]["efficiency"] == 1.0


def test_main_writes_the_json_payload(tmp_path, capsys):
    path = tmp_path / "scaling.json"
    scaling.main(["1", "48", "--device", "cpu", "--json", str(path)])
    out = capsys.readouterr().out
    assert "ranks=  4" in out and f"wrote {path}" in out
    payload = json.loads(path.read_text())
    assert payload["platform"] == "cpu" and payload["framebits"] == 48
    assert payload["frames_per_device"] == 1
    assert set(payload["sweep"]) == {"1", "2", "4"}
    assert all(set(r) == KEYS for r in payload["sweep"].values())
    assert "share" in payload["note"]


def test_sweep_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scaling.sweep(1, 48)
