"""The ``tdmb_stream`` configuration and the resident batch: the T-DMB mix's
geometry (its CUs fit a mode I CIF, p packets a CIF, 64 kept symbols a
CU), the pools the program and the reference read, the benchmark's own
RS(204,188) and interleaver, the outer stages' bounds, the CPU rehearsal
of ``tdmb_stream.bulk`` and ``dll_export.resident`` (correct, their
metrics by name, the control not correct), and on the card each cell
correct with every metric it lists.

    python -m pytest dabbench/tests/test_dabbench_tdmb.py -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dabbench import cells, roofline_tdmb
from dabbench.gen import channel
from dabbench.reference import tdmb as ref_tdmb
from dabbench.reference import viterbi as ref_vit

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "dabbench"
TDMB, RESIDENT = "tdmb_stream.bulk", "dll_export.resident"
#: EEP-3A's sub-channel size: 6 CUs a multiple of 8 kbit/s
CU_PER_8KBPS_3A = 6


def _run(*args, timeout=600):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), *args],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _args(cell, seed, trace=0, device="cpu"):
    out = ["--workload", cell, "--seed", str(seed), "--seconds", "1.5",
           "--trace", str(trace)]
    return out + (["--device", "cpu"] if device == "cpu" else [])


def _listed(cell, kind):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])}


def test_the_mix_fits_a_cif_in_whole_packets():
    signal = cells.load(TDMB).config["signals"]["ensemble"]
    cus = 0
    for s in signal["services"]:
        assert s["kbps"] % roofline_tdmb.PACKET_KBPS == 0
        assert (24 * s["kbps"] // 8) % ref_tdmb.N == 0
        cu = CU_PER_8KBPS_3A * s["kbps"] // 8
        kept = int(channel.eep_mask(s["kbps"], s["level"], s["profile"])
                   .sum())
        assert kept == 64 * cu, s
        cus += cu * s["streams"]
    assert cus == 816 <= 864


def test_the_benchmarks_rs204_and_interleaver():
    g = torch.Generator().manual_seed(5)
    msgs = torch.randint(0, 256, (64, ref_tdmb.K), generator=g,
                         dtype=torch.uint8)
    cws = ref_tdmb.rs_encode(msgs)
    assert (ref_tdmb.syndromes(cws.to(torch.int64)) == 0).all()
    hit = cws.clone()
    for i in range(64):
        pos = torch.randperm(ref_tdmb.N, generator=g)[:i % 12]
        hit[i, pos] ^= 0x5A
    count, data = ref_tdmb.rs_decode(hit)
    assert count.tolist() == [i % 12 if i % 12 <= 8 else -1
                              for i in range(64)]
    ok = count >= 0
    assert torch.equal(data[ok], msgs[ok])
    stream = cws.reshape(4, -1)
    sent = ref_tdmb.interleave(stream)
    got, carry = ref_tdmb.deinterleave(sent)
    assert (got[:, :ref_tdmb.DELAY] == 0).all()
    assert torch.equal(got[:, ref_tdmb.DELAY:], stream[:, :-ref_tdmb.DELAY])
    a, c1 = ref_tdmb.deinterleave(sent[:, :ref_tdmb.N * 3])
    b, c2 = ref_tdmb.deinterleave(sent[:, ref_tdmb.N * 3:], c1)
    assert torch.equal(torch.cat([a, b], 1), got) and torch.equal(c2, carry)


def test_the_pools_hold_the_kept_bytes_and_their_depuncture():
    cell = cells.load(TDMB, cpu=True)
    signal = dict(cell.config["signals"]["ensemble"], esn0_db=30.0)
    gen = torch.Generator().manual_seed(2**31 + 7)
    pools, events = cell.events.build(signal, cell.traffic, gen, "cpu")
    calls = events(0)
    assert [c.part for c in calls] == [0, 1]
    for pool in pools.values():
        kbps, (profile, level) = pool.kbps, pool.protection
        mask = channel.eep_mask(kbps, level, profile)
        assert pool.received.dtype == pool.symbols.dtype == np.uint8
        assert pool.received.shape[1] == int(mask.sum())
        assert np.array_equal(pool.symbols[:, mask], pool.received)
        assert (pool.symbols[:, ~mask] == 127).all()
        # a clean channel: the round's packets back, the injected -1
        c = calls[0]
        rows = c.parts * c.streams * c.cifs
        frames = ref_vit.decode(torch.from_numpy(pool.symbols[:rows]),
                                pool.framebits)
        cws, _ = ref_tdmb.deinterleave(frames.reshape(c.streams, -1))
        count, data = ref_tdmb.rs_decode(cws.reshape(-1, ref_tdmb.N))
        fill = ref_tdmb.DELAY // ref_tdmb.N
        assert (data[:fill] == 0).all()
        assert (data[fill:, 0][count[fill:] >= 0] == 0x47).all()
        assert set(count.tolist()) <= {0, -1} and (count == -1).any()


def test_the_outer_bounds_count_the_calls_bytes():
    class C:
        streams, cifs, part = 8, 100, 1
    n = roofline_tdmb.packets(C, 544)
    assert n == 8 * 100 * 8 == 6400
    assert roofline_tdmb.deinterleave_bound(C, 544) == pytest.approx(
        (2 * n * 204 + 2 * 8 * 1122) / 3.35e12)
    assert roofline_tdmb.rs_packets_bound(C, 544, 1.98e9) == pytest.approx(
        max(n * 396 / 3.35e12, n * 2 * 1632 * 128 / 1979e12))


@pytest.mark.parametrize("cell", [TDMB, RESIDENT])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cells_rehearse_correct_on_the_cpu(cell, trace):
    res = _run(*_args(cell, 2**33 + 11 + trace, trace))
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    if trace:
        # on the CPU the device readers find nothing; the spans do
        want = ({"chain.outer_span_share.tdmb",
                 "chain.depuncture_span_share.punctured"}
                if cell == TDMB else set())
    else:
        want = _listed(cell, "end_to_end")
    assert set(res["metrics"]) == want


def test_the_control_is_not_correct_on_the_cpu():
    res = _run(*_args(TDMB, 2**33 + 5), "--control")
    assert res["correct"] is False and res["failed"] > 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [TDMB, RESIDENT])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cells_run_correct_on_the_card(cell, trace):
    _card()
    res = _run(*_args(cell, 2147483659 + trace, trace, "cuda"))
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    assert set(res["metrics"]) == _listed(cell, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [TDMB, RESIDENT])
def test_the_control_is_not_correct_on_the_card(cell):
    _card()
    res = _run(*_args(cell, 2147483693, 0, "cuda"), "--control")
    assert res["correct"] is False
