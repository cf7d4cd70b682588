"""The evidence tools (``viterbi_tpu_torch.tools``) on the CPU at
tiny sizes: every tool's ``run(..., device="cpu")`` and its record's
schema and counts; the parity record's twelve sections with 0
mismatches; the overlap sweep's plain form against the JAX package's
``streaming.decode_stream(mesh, use_pallas=False)`` on the virtual
8-device mesh, cell for cell, and the kernel form's overlap rounding as a
table against the JAX planner; ``make_corpus`` into a fresh directory,
byte for byte against ``tests/data/corpus``; the raise without a card and
the refusal to write a CPU record under a ``_GPU.json`` name. On the card
(marker ``cuda``): the parity record's quick run launches kernels A to
D."""

import json
import os

import numpy as np
import pytest
import torch

import viterbi_tpu_torch
from viterbi_tpu_torch.tools import (_record, ingest, ladder, latency,
                                     make_corpus, overlap_sweep, parity,
                                     session, stream)

CORPUS = os.path.join(os.path.dirname(__file__), "data", "corpus")
ROOT = os.path.dirname(os.path.dirname(__file__))
SECTIONS = ("viterbi", "layout_classes", "torch_scan_small_frames", "rs",
            "tailbiting", "punctured", "packed_bt", "large_batch_blocked",
            "superframe_chain", "streaming_1chip", "arbitrary_framebits",
            "sharded_ensemble_chain")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only on the card)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", autouse=True)
def _fresh_config(tmp_path_factory):
    """A config file of this module's own: another test's rung override
    must not reach the tools' calls through the API. The API decodes on
    the CPU, as the tools' CPU runs ask."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VITERBI_TPU_TORCH_CONFIG",
                  str(tmp_path_factory.mktemp("config") / "viterbi.txt"))
        viterbi_tpu_torch.initialize(device="cpu")
        yield


@pytest.fixture(scope="module")
def parity_doc():
    return parity.run(quick=True, device="cpu", bitrates=(8, 32),
                      large=((192, 16), (384, 8)))


def test_parity_has_the_twelve_sections_of_the_tpu_record(parity_doc):
    with open(os.path.join(ROOT, "PARITY_TPU.json")) as f:
        tpu = json.load(f)["sections"]
    assert len(parity_doc["sections"]) == len(tpu) == 12
    renamed = {"jax_scan_small_frames": "torch_scan_small_frames"}
    assert set(parity_doc["sections"]) == {renamed.get(k, k) for k in tpu}
    assert parity_doc["ok"] and parity_doc["mismatches"] == 0
    assert parity_doc["device"] == {"platform": "cpu"}


@pytest.mark.parametrize("name", SECTIONS)
def test_parity_section_has_no_mismatch(parity_doc, name):
    sec = parity_doc["sections"][name]
    counts = {k: v for k, v in sec.items() if k.startswith("mismatch")}
    assert counts and not any(counts.values()), counts


def test_parity_viterbi_covers_every_rung_and_bitrate(parity_doc):
    cells = parity_doc["sections"]["viterbi"]["cells"]
    assert {(c["rung"], c["kbps"]) for c in cells} == {
        (r, k) for r in parity.RUNGS for k in (8, 32)}
    layout = parity_doc["sections"]["layout_classes"]
    assert [c["framebits"] for c in layout["cells"]] == list(
        parity.LAYOUT_FRAMEBITS)
    assert layout["lanes"] == [1, 4] and layout["segments"] == [
        1, 2, 4, 8, 16, 32]


def test_latency_record():
    doc = latency.run(iters=3, device="cpu", bitrates=(8,), batches=(1, 2),
                      sf_batches=(1,), warmup=1)
    assert doc["ok"] and doc["device"] == {"platform": "cpu"}
    assert [(r["batch"], r["call"]) for r in doc["deconvolve"]] == [
        (1, "deconvolve_batch"), (1, "resident"), (2, "deconvolve_batch"),
        (2, "resident")]
    for r in doc["deconvolve"] + doc["superframe_chain"]:
        assert 0 < r["p50_ms"] <= r["p99_ms"]
        assert r["headroom_p99"] == pytest.approx(r["budget_ms"]
                                                  / r["p99_ms"])
    assert [r["budget_ms"] for r in doc["deconvolve"]] == [24, 24, 48, 48]
    assert doc["superframe_chain"][0]["budget_ms"] == 120
    assert set(doc["dispatch_floor_ms"]) == {"p50_ms", "p99_ms"}
    assert doc["rung"] == "torch_blocked"


def test_ladder_record():
    doc = ladder.run(batches=(2,), iters=1, device="cpu", bitrates=(8, 16),
                     rounds=1)
    rows = doc["ladders"]["2"]["rows"]
    assert doc["ok"] and [r["framebits"] for r in rows] == [192, 384]
    assert all(r["mismatch_frames"] == 0 for r in rows)
    per_fb = [r["us_per_kframebit"] for r in rows]
    assert doc["ladders"]["2"]["time_per_framebit_ratio_maxmin"] == \
        pytest.approx(max(per_fb) / min(per_fb))


def test_stream_record():
    doc = stream.run(device="cpu", parity=(192,), throughput=((288, 2),),
                     blk=96, parity_streams=2)
    assert doc["ok"]
    cell = doc["parity"]["192"]
    assert cell["equal_plain"] and cell["equal_whole"]
    assert (cell["streams"], cell["n_blocks"]) == (2, 2)
    tp = doc["throughput"]["288"]
    assert tp["predicted_overhead"] == pytest.approx(
        (tp["layout"]["overlap"] + tp["layout"]["warmup"]) / 96)
    assert tp["measured_overhead"] == pytest.approx(1 - tp["ratio_vs_fused"])


def test_session_record():
    doc = session.run(device="cpu", streams=2, chunk_sizes=(1, 2),
                      framebits=96, min_frames=6)
    assert doc["ok"] and set(doc["chunks"]) == {"1", "2"}
    for c, rec in doc["chunks"].items():
        assert rec["match_one_shot"]
        assert rec["chunk_ms_realtime_budget"] == 24.0 * int(c)
        # 96-bit chunks: the emit boundary sits 120 bits (the overlap) and
        # the rounding to 24 behind the newest arrival
        assert 120 <= rec["emit_lag_bits_min"] <= rec["emit_lag_bits_max"] \
            < 120 + 24
        # the first 96-bit push is inside the overlap and emits nothing;
        # no push holds back more than the overlap and the rounding
        assert rec["every_push_emitted"] == (96 * int(c) > 120)
        assert rec["none_held_back"] and rec["unemitted_bits_max"] < 120 + 24


def test_ingest_record_keeps_the_tpu_record_keys():
    doc = ingest.run(device="cpu", framebits=96, batch=4, nbatches=2,
                     ring_frames=64, rounds=1)
    with open(os.path.join(ROOT, "INGEST_TPU.json")) as f:
        tpu = json.load(f)
    assert set(tpu) <= set(doc)
    assert doc["ok"] and doc["mismatch_frames"] == 0
    assert doc["ring_push_pop_frames_per_s"] > 0
    assert set(doc["feed_ms_for_8_batches"]) == {"serial", "depth 1",
                                                 "depth 2"}


def _jax_counts(n_seq, blk, batch, seed, ebn0, cells):
    """The JAX sweep's counts of ``cells`` [(overlap, warm-up)]: its XLA
    ring on the virtual mesh against its whole-stream decode."""
    import jax
    import jax.numpy as jnp

    from viterbi_tpu import constants as JC
    from viterbi_tpu.harness import channel
    from viterbi_tpu.ops import acs, traceback as jtb
    from viterbi_tpu.parallel import mesh as JM, streaming as JS
    stream_bits = n_seq * blk
    mesh = JM.make_mesh(n_data=1, n_seq=n_seq, devices=jax.devices()[:n_seq])
    _, syms = channel.make_frames(batch, stream_bits, seed=seed,
                                  ebn0_db=ebn0)
    syms = jnp.asarray(syms.astype(np.int32))
    dec, _ = acs.forward(syms, stream_bits + JC.TAIL_BITS)
    ref = np.asarray(jtb.chainback_blocked(dec, stream_bits, block=64))
    out = {}
    for ov, w in cells:
        got = np.asarray(JS.decode_stream(syms, stream_bits, mesh, overlap=ov,
                                          use_pallas=False, warmup=w))
        out[(ov, w)] = (int(np.unpackbits(got ^ ref).sum()),
                        int((got != ref).any(axis=1).sum()))
    return out


def test_overlap_sweep_plain_form_matches_the_jax_sweep():
    overlaps, warmups = (8, 24, 48, 70, 96), (16, 64)
    doc = overlap_sweep.run(device="cpu", n_seq=4, block_bits=96, batch=4,
                            seeds=(0,), ebn0s=(0.0,), overlaps=overlaps,
                            warmups=warmups, warmup_overlap=48)
    assert doc["ok"] and doc["kernel_cells_differing"] == 0
    # no committed record at these settings: nothing compared there
    assert doc["reference_cells_compared"] == 0
    cells = [(ov, 128) for ov in overlaps] + [(48, w) for w in warmups]
    want = _jax_counts(4, 96, 4, 0, 0.0, cells)
    got = {(c["overlap"], c["warmup"]): (c["mismatch_bits"],
                                         c["mismatch_frames"])
           for c in doc["plain_cells"]}
    assert got == want
    # the truncation shows at 0 dB: short overlaps lose bits
    assert want[(8, 128)][0] > want[(96, 128)][0]
    for c in doc["kernel_cells"]:
        assert c["equal_to_plain_at_effective"]
        assert (c["effective_overlap"], c["effective_warmup"]) == \
            overlap_sweep.effective(96, c["overlap"], c["warmup"])


# (block bits, requested overlap, warm-up) -> the kernel form's: the
# production block's checkpoint 18 and a small block's 6
ROUNDING = [
    ((3072, 8, 128), (24, 126)), ((3072, 16, 128), (24, 126)),
    ((3072, 24, 128), (24, 126)), ((3072, 36, 128), (42, 126)),
    ((3072, 48, 128), (60, 126)), ((3072, 70, 128), (78, 126)),
    ((3072, 96, 128), (96, 126)), ((3072, 120, 128), (132, 126)),
    ((3072, 120, 16), (132, 18)), ((3072, 120, 32), (132, 18)),
    ((3072, 120, 64), (132, 54)), ((3072, 120, 256), (132, 252)),
    ((96, 8, 128), (12, 96)), ((96, 70, 128), (72, 96)),
    ((96, 48, 16), (48, 12)),
]


@pytest.mark.parametrize("asked,runs", ROUNDING)
def test_overlap_rounding_table(asked, runs):
    from viterbi_tpu.parallel import streaming as JS
    assert overlap_sweep.effective(*asked) == runs
    assert JS._plan_block_layout(*asked, use_pallas=True)[:2] == runs


def test_the_full_sweep_reads_the_committed_record():
    cells = overlap_sweep._reference_cells(8, 3072, 64)
    assert len(cells) == 72
    assert cells[(0.0, 0, 120, 128)]["mismatch_bits"] == 0
    assert overlap_sweep._reference_cells(4, 96, 4) is None


def test_at_the_records_settings_every_plain_cell_is_compared(
        tmp_path, monkeypatch):
    """A sweep at the record's n_seq, block bits and batch fails unless
    the record holds every one of its plain cells."""
    for name, v in (("N_SEQ", 4), ("BLOCK_BITS", 96), ("BATCH", 4)):
        monkeypatch.setattr(overlap_sweep, name, v)
    record = tmp_path / "OVERLAP_SWEEP.json"
    monkeypatch.setattr(overlap_sweep, "REFERENCE", record)
    kw = dict(device="cpu", n_seq=4, block_bits=96, batch=4, seeds=(0,),
              ebn0s=(0.0,), overlaps=(24, 96), warmups=())
    doc = overlap_sweep.run(**kw)          # no record
    assert doc["at_reference_settings"] and not doc["ok"]
    assert doc["reference_cells_compared"] == 0
    cells = [{k: c[k] for k in ("ebn0_db", "seed", "overlap", "warmup",
                                "mismatch_bits", "mismatch_frames")}
             for c in doc["plain_cells"]]
    for held in (cells, cells[:1]):
        record.write_text(json.dumps(dict(n_seq=4, block_bits=96, batch=4,
                                          cells=held)))
        doc = overlap_sweep.run(**kw)
        assert doc["reference_cells_differing"] == 0
        assert doc["reference_cells_compared"] == len(held)
        assert doc["ok"] == (len(held) == len(cells))


def test_make_corpus_reproduces_the_committed_corpus(tmp_path):
    out = tmp_path / "corpus"
    assert make_corpus.main([str(out), "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == sorted(os.listdir(CORPUS))
    for name in os.listdir(CORPUS):
        if name.endswith(".npy"):
            with open(out / name, "rb") as a, \
                    open(os.path.join(CORPUS, name), "rb") as b:
                assert a.read() == b.read(), name
        else:      # .npz: zip entries carry their write time
            got, want = np.load(out / name), np.load(os.path.join(CORPUS,
                                                                  name))
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (name, k)


def test_make_corpus_never_writes_the_committed_corpus():
    with pytest.raises(ValueError, match="committed corpus"):
        make_corpus.run(CORPUS, device="cpu")


RUNS = {
    "parity": lambda: parity.run(quick=True),
    "latency": lambda: latency.run(iters=1),
    "ladder": lambda: ladder.run(batches=(1,)),
    "stream": lambda: stream.run(),
    "session": lambda: session.run(),
    "ingest": lambda: ingest.run(),
    "overlap_sweep": lambda: overlap_sweep.run(),
    "make_corpus": lambda: make_corpus.run("unused"),
}


@pytest.mark.parametrize("tool", sorted(RUNS))
def test_without_a_card_every_tool_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RUNS[tool]()


def test_a_cpu_record_is_never_written_as_gpu(tmp_path, capsys):
    doc = {"device": _record.stamp(torch.device("cpu")), "ok": True}
    with pytest.raises(ValueError, match="not written"):
        _record.finish(doc, tmp_path / "LATENCY_GPU.json", "LATENCY")
    assert not (tmp_path / "LATENCY_GPU.json").exists()
    assert _record.finish(doc, None, "LATENCY") == 0     # no file at all
    assert _record.finish(dict(doc, ok=False), tmp_path / "x.json",
                          "LATENCY") == 1
    assert json.loads((tmp_path / "x.json").read_text())["ok"] is False


@pytest.mark.cuda
def test_parity_quick_launches_kernels_a_to_d_on_the_card(cuda):
    viterbi_tpu_torch.initialize(device=cuda)
    doc = parity.run(quick=True)
    assert doc["ok"] and doc["mismatches"] == 0
    assert not _record.missing(doc["launches"], _record.KERNELS)
    assert doc["device"]["platform"] == "gpu" and doc["device"]["card"]


@pytest.mark.cuda
def test_overlap_sweep_corner_on_the_card(cuda):
    doc = overlap_sweep.run(seeds=(0,), ebn0s=(0.0,), overlaps=(24, 96),
                            warmups=())
    assert doc["ok"] and doc["reference_cells_compared"] == 2
