"""The port's spans and counters (``runtime.calllog``): each export and
the DAB+ chain as one tree of spans a call, on a torch profiler's
timeline and in ``calllog.spans()``; the counters against the bytes
handed over and the kernels' launch counts; nothing recorded and no
profiler span entered while tracing is off; a tree a thread; spans under
call logging alone, the log's stage times, and each logged line in the
file as its call returns."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

import viterbi_tpu_torch
from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.models import dab
from viterbi_tpu_torch.ops import _build, acs_cuda, counts
from viterbi_tpu_torch.ops import deinterleave as dl
from viterbi_tpu_torch.ops import depuncture as dp
from viterbi_tpu_torch.ops import rs as rs_ops
from viterbi_tpu_torch.ops import traceback as tb
from viterbi_tpu_torch.runtime import calllog, dispatch
from viterbi_tpu_torch.runtime import config as config_mod

FRAMEBITS = 48
KBPS = 8
RS_DIMS = 3

#: each entry point's tree: its root and the root's stages, in order
TREES = {
    "deconvolve": ("api.deconvolve", ["ingest", "viterbi", "readback"]),
    "deconvolve_batch": ("api.deconvolve_batch",
                         ["ingest", "viterbi", "readback"]),
    "rs_check_superframe": ("api.rs_check_superframe",
                            ["ingest", "rs", "readback"]),
    "chain": ("chain", ["ingest", "viterbi", "rs"]),
}
#: each kernel of ``counts.KERNELS`` by its wrapper (module, name), which
#: on the CPU runs the plain version and launches nothing
WRAPPERS = {"acs_regs": (acs_cuda, "forward_regs"),
            "acs_words": (acs_cuda, "forward"),
            "tb_walk": (tb, "tb_walk"), "tb_words": (tb, "tb_words"),
            "rs_decode": (rs_ops, "rs_decode_blocks"),
            "rs_superframes": (rs_ops, "rs_check_superframes"),
            "depuncture": (dp, "depuncture"),
            "rs_packets": (rs_ops, "rs_decode_packets"),
            "deinterleave": (dl, "deinterleave")}


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    viterbi_tpu_torch.initialize(device="cpu")
    calllog.spans(clear=True)
    yield
    calllog.configure(False)
    calllog.spans(clear=True)
    viterbi_tpu_torch.initialize()


def _frame_syms(n=1, seed=1):
    bits = np.random.default_rng(seed).integers(0, 2, (n, FRAMEBITS),
                                                dtype=np.uint8)
    syms = np.stack([golden.hard_to_soft(golden.encode(b)) for b in bits])
    return bits, syms.astype(np.int32)


def _rs_superframe(seed=2):
    msgs = np.random.default_rng(seed).integers(0, 256, (RS_DIMS, C.RS_KK),
                                                dtype=np.uint8)
    cws = golden.rs_encode_many(msgs)
    return msgs.T.reshape(-1), cws.T.reshape(-1).astype(np.uint8)


def _call(entry, device="cpu"):
    """Runs one call of ``entry`` (the chain on ``device``) and checks
    its output; returns the bytes of the input it handed over."""
    if entry in ("deconvolve", "deconvolve_batch"):
        n = 1 if entry == "deconvolve" else 3
        bits, syms = _frame_syms(n)
        if entry == "deconvolve":
            out = np.empty(FRAMEBITS // 8, np.uint8)
            assert viterbi_tpu_torch.deconvolve(FRAMEBITS, syms[0], 0,
                                                out) == 0
            got = out[None]
        else:
            ret, got = viterbi_tpu_torch.deconvolve_batch(FRAMEBITS, syms)
            assert ret == 0
        assert np.array_equal(got, np.packbits(bits, axis=1))
        return syms.nbytes
    if entry == "rs_check_superframe":
        data, sf = _rs_superframe()
        out = np.empty(RS_DIMS * C.RS_KK, np.uint8)
        assert viterbi_tpu_torch.rs_check_superframe(sf, 0, RS_DIMS,
                                                     out) == 0
        assert np.array_equal(out, data)
        return sf.nbytes
    audio, syms = channel.make_superframes(2, KBPS, seed=3)
    got, errors = dab.decode_audio_superframes(syms, KBPS, device=device)
    assert (errors >= 0).all()
    assert np.array_equal(got.cpu().numpy(), audio.reshape(2, -1))
    return syms.astype(np.int32).nbytes


def _one_tree(records, entry):
    """The records of one call: one request, the root last, its stages
    in order, each inside the root's interval on one thread."""
    root_name, stages = TREES[entry]
    assert len({r.request for r in records}) == 1
    assert len({r.thread for r in records}) == 1
    *kids, root = records
    assert (root.name, root.parent) == (root_name, None)
    assert [r.name for r in kids] == stages
    assert all(r.parent == root_name for r in kids)
    assert all(root.t0_ns <= r.t0_ns <= r.t1_ns <= root.t1_ns for r in kids)
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(kids, kids[1:]))
    return root, {r.name: r for r in kids}


@pytest.mark.parametrize("entry", list(TREES))
def test_a_profiler_sees_each_call_as_one_tree(entry, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _call(entry)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("ph") == "X"
                    and e.get("name", "").startswith(calllog.PREFIX)),
                   key=lambda e: e["ts"])
    root_name, stages = TREES[entry]
    names = [e["name"].removeprefix(calllog.PREFIX) for e in spans]
    assert names == [root_name] + stages
    root = spans[0]
    end = root["ts"] + root["dur"]
    for e in spans[1:]:
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end
    _one_tree(calllog.spans(), entry)


def _counting(monkeypatch, name, form=None):
    """Count each call of kernel ``name``'s wrapper as the launch path
    counts a launch on a card, in ``form`` (the wrapper runs its plain
    version here); the kernel's tally is restored after the test."""
    module, attr = WRAPPERS[name]
    real, kernel = getattr(module, attr), counts.KERNELS[name]
    monkeypatch.setattr(kernel, "tally", dict(kernel.tally))

    def wrapper(*args, **kwargs):
        kernel.tally[form] += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(module, attr, wrapper)


def _count_all(monkeypatch, lanes=acs_cuda.WARP_LANES):
    """Every kernel counted as on a card, kernel A in the form ``lanes``
    (a card's below ``REGS_WARP_FRAMES`` frames, as every call here)."""
    for name in counts.KERNELS:
        _counting(monkeypatch, name, lanes if name == "acs_regs" else None)


@pytest.mark.parametrize("entry", list(TREES))
def test_counters_match_the_bytes_and_the_launch_counts(entry, monkeypatch):
    """With the kernels' wrappers counted as on a card (each runs its
    plain version here) and the fused rung selected, the stages' launches
    add up to ``ops.counts`` over the call; ``h2d_bytes`` is the input
    handed over, through the direct path (no chunk staged)."""
    _count_all(monkeypatch)
    monkeypatch.setattr(dispatch.state(), "variant",
                        dispatch.VARIANTS.index("cuda_fused"))
    before = counts.total()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        nbytes = _call(entry)
    launched = counts.total() - before
    _, stages = _one_tree(calllog.spans(), entry)
    assert stages["ingest"].counters == {"h2d_bytes": nbytes,
                                         "staged_chunks": 0}
    assert sum(r.counters.get("launches", 0) for r in stages.values()) \
        == launched
    if entry.startswith("deconvolve"):
        # kernel A's wrapper; kernel B's walk with the bytes
        # (``tb_walk_bytes``) counts as ``tb_walk`` only on a card
        assert stages["viterbi"].counters == {
            "launches": 1, "acs_lanes": acs_cuda.WARP_LANES}
        rows = 1 if entry == "deconvolve" else 3
        assert stages["readback"].counters == {
            "d2h_bytes": rows * FRAMEBITS // 8}
    elif entry == "rs_check_superframe":
        assert stages["rs"].counters == {"launches": 1}


@pytest.mark.parametrize("entry,lanes", [("deconvolve", 32),
                                         ("deconvolve_batch", 4),
                                         ("deconvolve_batch", 1),
                                         ("chain", 32), ("chain", 4)])
def test_viterbi_span_names_kernel_a_form(entry, lanes, monkeypatch):
    """The viterbi stage's ``acs_lanes`` is the form kernel A launched in
    (here a wrapper that counts a launch in the form named, as a card's
    would, and runs the plain version), and the per-form tally moved by
    the stage's one launch; the RS stage, where kernel A does not
    launch, names no form; ``zero_launches`` clears the tally. The chain
    takes its kernel path, as on a card."""
    _counting(monkeypatch, "acs_regs", lanes)
    monkeypatch.setattr(dispatch.state(), "variant",
                        dispatch.VARIANTS.index("cuda_fused"))
    monkeypatch.setattr(dab, "want_kernels", lambda *args: True)
    tally = _build.ACS_REGS.tally
    before = dict(tally)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _call(entry)
    _, stages = _one_tree(calllog.spans(), entry)
    assert stages["viterbi"].counters == {"launches": 1, "acs_lanes": lanes}
    if "rs" in stages:
        assert stages["rs"].counters == {"launches": 0}
    moved = {k: n - before[k] for k, n in tally.items()}
    assert moved == {k: int(k == lanes) for k in before}
    counts.zero_launches()
    assert set(tally.values()) == {0}


@pytest.mark.parametrize("entry", list(TREES))
def test_tracing_off_a_stage_counts_nothing(entry, monkeypatch):
    """Off, a stage is the span's shared no-op object: it reads no count
    (``counts.total`` and kernel A's tally are never read) and leaves no
    record, with every kernel counted as on a card."""
    _count_all(monkeypatch)

    def refuse(*args, **kwargs):
        raise AssertionError("a count was read with tracing off")
    monkeypatch.setattr(counts, "total", refuse)
    monkeypatch.setattr(counts, "_Stage", refuse)
    with counts.stage("viterbi") as sp:
        assert sp is calllog.span("viterbi") and not sp
    _call(entry)
    assert calllog.spans() == []


@pytest.mark.parametrize("stray", list(counts.KERNELS))
def test_only_holds_every_kernel_to_its_count(stray, monkeypatch):
    """``counts.only``: exactly the named launches, and none of any kernel
    not named; a stray launch of ``stray`` fails every check that does
    not name it, and a name no kernel has raises."""
    for kernel in counts.KERNELS.values():
        monkeypatch.setattr(kernel, "tally", dict(kernel.tally))
    counts.zero_launches()
    assert counts.only({}) and counts.only({stray: 0})
    kernel = counts.KERNELS[stray]
    kernel.tally[next(iter(kernel.tally))] += 1
    assert counts.only({stray: 1})
    assert not counts.only({})
    assert not counts.only({stray: 2})
    others = [k for k in counts.KERNELS if k != stray]
    assert not counts.only({k: 1 for k in others})
    assert not counts.only({stray: 1, others[0]: 1})
    assert counts.only({stray: 1, others[0]: 0}, counts.launches())
    with pytest.raises(ValueError, match="no kernel named"):
        counts.only({"kernel_z": 0})


def _refuse_profiler_spans(monkeypatch):
    """Every form of a profiler span raises if entered."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler span was entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)


def test_tracing_off_records_nothing_and_enters_no_profiler_span(
        monkeypatch):
    _refuse_profiler_spans(monkeypatch)
    for entry in TREES:
        _call(entry)
    assert calllog.spans() == []


def test_two_threads_calling_at_once_get_a_tree_each(tmp_path):
    calllog.configure(True, False, str(tmp_path / "log"))
    _, syms = _frame_syms()
    barrier = threading.Barrier(2, timeout=60)
    results = []

    def caller():
        barrier.wait()
        for _ in range(20):
            results.append(viterbi_tpu_torch.deconvolve(FRAMEBITS, syms[0]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert results == [0] * 40
    by_request = {}
    for r in calllog.spans():
        by_request.setdefault(r.request, []).append(r)
    assert len(by_request) == 40
    roots = [_one_tree(recs, "deconvolve")[0]
             for recs in by_request.values()]
    assert sorted(len([r for r in roots if r.thread == t.ident])
                  for t in threads) == [20, 20]


def test_call_logging_alone_records_spans_and_logs_the_stages(
        tmp_path, monkeypatch):
    """``log_calls=1`` turns the spans on with no profiler running, and
    then enters no profiler span; the log stays open across calls and
    gains each call's stage times and ``h2d_bytes``."""
    _refuse_profiler_spans(monkeypatch)
    base = str(tmp_path / "log")
    calllog.configure(True, False, base)
    opened = []
    monkeypatch.setattr(calllog, "open", lambda *a, **k: opened.append(a),
                        raising=False)
    try:
        nbytes = _call("deconvolve")
        _call("rs_check_superframe")
        _call("deconvolve")
        assert opened == []
        by_request = {}
        for r in calllog.spans():
            by_request.setdefault(r.request, []).append(r)
        assert [recs[-1].name for recs in by_request.values()] == [
            "api.deconvolve", "api.rs_check_superframe", "api.deconvolve"]
        for recs in by_request.values():
            _one_tree(recs, recs[-1].name.removeprefix("api."))
        stages = calllog.summary()["stages"]
        assert stages["ingest"]["count"] == 3
        assert stages["viterbi"]["count"] == 2 and stages["rs"]["count"] == 1
        assert stages["ingest"]["h2d_bytes"] == \
            2 * nbytes + RS_DIMS * C.RS_N
    finally:
        monkeypatch.undo()
        calllog.configure(False)
    log = (tmp_path / "log.log").read_text()
    lines = [ln for ln in log.splitlines() if "deco:" in ln and "ReE:" in ln]
    assert len(lines) == 2
    assert all("ingest " in ln and "viterbi " in ln and "readback " in ln
               and f"h2d_bytes={nbytes}" in ln for ln in lines)
    assert "stage ingest: 3 spans" in log


def test_each_logged_line_is_in_the_file_when_its_call_returns(tmp_path):
    """The log is line-buffered: a call's line, with its request id and
    stage times, is in the file as soon as the call returns, before the
    flush at disable or exit, and no line is written twice."""
    calllog.configure(True, False, str(tmp_path / "log"))
    nbytes = _call("deconvolve")
    for n in range(3):
        lines = [ln for ln in (tmp_path / "log.log").read_text()
                 .splitlines() if "deco:" in ln]
        assert [int(ln.split()[0]) for ln in lines] == list(range(n + 1))
        assert "framebits=48" in lines[-1] and "readback " in lines[-1]
        assert f"h2d_bytes={nbytes}" in lines[-1]
        _call("deconvolve")
    assert calllog.summary()["calls"] == 4


@pytest.mark.cuda
def test_on_the_card_the_stages_count_the_kernels_and_the_copies():
    """On the card each export and the chain count their own kernels
    (A and B a Viterbi stage, I an RS stage, with kernel A's form: these
    batches take the warp-wide one) and copies, and the profiler sees
    every span beside the device's operations. The traced ``deconvolve``
    is its size's second call, so it replays the size's plan
    (``graphed`` 1): one byte a symbol copied up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    dev = torch.device("cuda", 0)
    viterbi_tpu_torch.initialize(device=dev)
    _call("deconvolve", dev)                # the size's eager first call
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    nbytes = {}
    with torch.profiler.profile(activities=acts) as prof:
        for entry in TREES:
            nbytes[entry] = _call(entry, dev)
    torch.cuda.synchronize()
    nbytes["deconvolve"] //= np.dtype(np.int32).itemsize
    by_request = {}
    for r in calllog.spans():
        by_request.setdefault(r.request, []).append(r)
    assert len(by_request) == len(TREES)
    for entry, recs in zip(TREES, by_request.values()):
        root, stages = _one_tree(recs, entry)
        assert stages["ingest"].counters == {"h2d_bytes": nbytes[entry],
                                             "staged_chunks": 0}
        if entry == "deconvolve":
            assert root.counters == {"graphed": 1}
        if "viterbi" in stages:
            assert stages["viterbi"].counters == {
                "launches": 2, "acs_lanes": acs_cuda.WARP_LANES}
        if "rs" in stages:
            assert stages["rs"].counters == {"launches": 1}
    names = {e.key for e in prof.key_averages()}
    for root, stages in TREES.values():
        assert {calllog.PREFIX + n for n in [root] + stages} <= names
