"""The one-frame plans of ``deconvolve`` (``runtime.frameplan``): which
calls take one, the pinned input's bytes, the cache's key, bound, order
and drop, a busy plan's fallback, the launches each replay counts, and
threads; on the card, the replayed call against golden at the DAB+ sizes,
its launch counts, two threads on one size and the fault latch.

On the CPU a plan's capture and replay are stubbed (``CpuPlan``): the
capture records two launches through the launch path, as a graph's would,
and the replay decodes the plan's input with the kernels' plain versions.
"""

import sys
import threading
import types

import numpy as np
import pytest
import torch

import viterbi_tpu_torch
from viterbi_tpu_torch import api, golden
from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch.harness import benchmark, channel
from viterbi_tpu_torch.ops import _build, acs_cuda, counts
from viterbi_tpu_torch.runtime import calllog, dispatch, frameplan
from viterbi_tpu_torch.runtime import config as config_mod

FRAMEBITS = 48
CARD = torch.device("cuda", 0)
CPU = torch.device("cpu")
FUSED = dispatch.VARIANTS.index("cuda_fused")
#: the DAB+ frame sizes of the benchmark's export cell, and 3072 bits
SIZES = (768, 1152, 1536, 2304, 3072)


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    viterbi_tpu_torch.initialize(device="cpu")
    calllog.spans(clear=True)
    yield
    calllog.configure(False)
    calllog.spans(clear=True)
    viterbi_tpu_torch.initialize()


def _frames(n, framebits=FRAMEBITS, seed=1):
    """(golden's bytes, int32 symbols) of ``n`` noisy frames."""
    _, syms = channel.make_frames(n, framebits, seed=seed)
    syms = syms.astype(np.int32)
    return golden.deconvolve_many(framebits, syms), syms


def _keys(cache):
    """The keys a ``PlanCache`` holds, the least recently used first."""
    return list(cache._plans)


def _card_state(variant=FUSED, device=CARD):
    return types.SimpleNamespace(device=device, variant=variant)


class _Done:
    """The replay's event on the CPU: nothing to wait for."""

    def synchronize(self):
        pass


class CpuPlan(frameplan.FramePlan):
    """A plan on the CPU: the capture records one launch of kernel A in
    its warp-wide form and one of kernel B through the launch path, and
    the replay decodes the copied input with the plain versions."""

    def _capture(self):
        with _build.recording() as made:
            _build.ACS_REGS.launch(CARD, form=acs_cuda.WARP_LANES)
            _build.TB_WALK.launch(CARD)
        self.graph, self.made, self.done = "graph", made, _Done()

    def _replay(self):
        self.dev_in.copy_(self.host_in)
        nsteps = self.framebits + C.TAIL_BITS
        words = self.dev_in.view(torch.int32).view(1, nsteps)
        out = acs_cuda.decode(words, self.framebits, packed="bt",
                              initial_metrics=self.metrics)
        self.host_out.copy_(out[0])


def _cpu_cache(bound=frameplan.PLANS):
    return frameplan.PlanCache(bound, lambda dev, fb: CpuPlan(CPU, fb))


@pytest.fixture
def fake_launches(monkeypatch):
    """Kernels A and B launch on the CPU as on a card: the C function is
    a stub that accepts the launch; every tally is this test's own."""
    for kernel in counts.KERNELS.values():
        monkeypatch.setattr(kernel, "tally", dict(kernel.tally))
    for kernel in (_build.ACS_REGS, _build.TB_WALK):
        monkeypatch.setattr(kernel, "_fn", lambda *args: 0)
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 0)
    counts.zero_launches()


_, _SYMS = _frames(1)
#: (dispatcher, symbols, framebits) -> whether the call takes a plan
TAKES = {
    "card_fused_int32": (_card_state(), _SYMS[0], FRAMEBITS, True),
    "int64": (_card_state(), _SYMS[0].astype(np.int64), FRAMEBITS, True),
    "int16": (_card_state(), _SYMS[0].astype(np.int16), FRAMEBITS, True),
    "uint8": (_card_state(), _SYMS[0].astype(np.uint8), FRAMEBITS, True),
    "uint32": (_card_state(), _SYMS[0].astype(np.uint32), FRAMEBITS, True),
    "cpu_tensor": (_card_state(), torch.from_numpy(_SYMS[0]), FRAMEBITS,
                   True),
    "strided": (_card_state(), np.repeat(_SYMS[0], 2)[::2], FRAMEBITS, True),
    "float32": (_card_state(), _SYMS[0].astype(np.float32), FRAMEBITS,
                False),
    "float64": (_card_state(), _SYMS[0].astype(np.float64), FRAMEBITS,
                False),
    "bool": (_card_state(), _SYMS[0] > 127, FRAMEBITS, False),
    "byte_swapped": (_card_state(), _SYMS[0].astype(">i4"), FRAMEBITS,
                     False),
    "off_the_byte_grid": (_card_state(), _SYMS[0][:4 * 50], 44, False),
    "cpu_device": (_card_state(device=CPU), _SYMS[0], FRAMEBITS, False),
    **{f"rung_{name}": (_card_state(dispatch.VARIANTS.index(name)),
                        _SYMS[0], FRAMEBITS, False)
       for name in ("torch_scan", "torch_blocked", "cuda_words")},
}


@pytest.mark.parametrize("case", list(TAKES))
def test_which_calls_take_a_plan(case):
    """A card, the fused rung, framebits on the byte grid and host
    integers take a plan; every other call keeps the eager path."""
    st, syms, framebits, taken = TAKES[case]
    src = frameplan.takes(st, syms, framebits)
    assert (src is not None) == taken
    if taken:
        assert src.device.type == "cpu" and not src.is_floating_point()


#: host symbols of every integer width, with values outside 0..255
WRAPS = {
    "int32_wide": (np.int32, -2**31, 2**31 - 1),
    "int32_negative": (np.int32, -300, -1),
    "int64_wide": (np.int64, -2**40, 2**40),
    "int16": (np.int16, -2**15, 2**15 - 1),
    "uint8": (np.uint8, 0, 255),
    "uint32": (np.uint32, 0, 2**32 - 1),
}


@pytest.mark.parametrize("case", list(WRAPS))
def test_the_pinned_input_holds_the_packed_words(case, fake_launches):
    """The narrowing wraps each symbol to its low byte: the pinned input
    is, word for word, ``pack_symbols_host`` of the symbols, and the
    frame decodes as golden decodes it."""
    dtype, lo, hi = WRAPS[case]
    width = C.RATE * (FRAMEBITS + C.TAIL_BITS)
    syms = np.random.default_rng(7).integers(lo, hi, width, dtype=dtype,
                                             endpoint=True)
    cache = _cpu_cache()
    for _ in range(2):
        got = cache.decode(_card_state(), syms, FRAMEBITS)
    plan = cache.plan(CARD, FRAMEBITS)
    words = plan.host_in.view(torch.int32).numpy()
    assert np.array_equal(words, acs_cuda.pack_symbols_host(syms[None])[0])
    assert np.array_equal(got, golden.deconvolve(FRAMEBITS, syms))


def test_the_cache_keys_a_plan_by_device_and_size():
    """A key's first sight makes no plan, its second makes one, later
    ones find the same; another device or size is another key."""
    made = []
    cache = frameplan.PlanCache(4, lambda dev, fb: made.append((dev, fb))
                                or len(made))
    assert cache.plan(CARD, 768) is None and made == []
    assert cache.plan(CARD, 768) == 1 and made == [(CARD, 768)]
    assert cache.plan(CARD, 768) == 1 and len(made) == 1
    other = torch.device("cuda", 1)
    assert cache.plan(other, 768) is None and cache.plan(CARD, 1152) is None
    assert cache.plan(other, 768) == 2 and made[-1] == (other, 768)
    assert _keys(cache) == [(CARD, 768), (CARD, 1152), (other, 768)]


def test_the_cache_drops_the_least_recently_used():
    """At its bound the cache drops the key used longest ago; a use
    moves a key to the back; a dropped key starts again at first sight;
    ``clear`` drops every key."""
    cache = frameplan.PlanCache(3, lambda dev, fb: fb)
    for fb in (8, 16, 24):
        cache.plan(CARD, fb)
    assert cache.plan(CARD, 8) == 8                  # 8 now most recent
    cache.plan(CARD, 32)                            # drops 16
    assert _keys(cache) == [(CARD, 24), (CARD, 8), (CARD, 32)]
    assert cache.plan(CARD, 16) is None              # seen anew; drops 24
    assert _keys(cache) == [(CARD, 8), (CARD, 32), (CARD, 16)]
    cache.clear()
    assert _keys(cache) == [] and cache.plan(CARD, 8) is None


def test_the_api_bounds_its_cache_and_initialize_drops_every_plan(
        monkeypatch):
    assert frameplan.CACHE.bound == frameplan.PLANS == 16
    monkeypatch.setattr(frameplan.CACHE, "make", lambda dev, fb: fb)
    for _ in range(2):
        frameplan.CACHE.plan(CARD, 768)
    assert _keys(frameplan.CACHE) == [(CARD, 768)]
    viterbi_tpu_torch.initialize(device="cpu")
    assert _keys(frameplan.CACHE) == []


def test_a_busy_plan_sends_the_call_the_eager_way(fake_launches):
    """While another caller holds a size's plan, a call of that size
    gets None (the eager path) at once and the plan does not run."""
    want, syms = _frames(2)
    cache = _cpu_cache()
    assert cache.decode(_card_state(), syms[0], FRAMEBITS) is None
    assert np.array_equal(cache.decode(_card_state(), syms[0], FRAMEBITS),
                          want[0])
    plan = cache.plan(CARD, FRAMEBITS)
    with plan.lock:
        assert cache.decode(_card_state(), syms[1], FRAMEBITS) is None
    assert (plan.captures, plan.replays) == (1, 1)
    assert np.array_equal(cache.decode(_card_state(), syms[1], FRAMEBITS),
                          want[1])
    assert cache.stats() == {"plans": 1, "captures": 1, "replays": 2}


def test_each_replay_adds_the_captured_launches(fake_launches):
    """The capture's launches go to the plan, not to the tallies; each
    replay adds them once, so after n replays ``counts`` reads n
    launches of kernels A and B, A in its warp-wide form, and each
    traced call's stages count as the eager path's: two launches, the
    bytes copied up (one a symbol) and back."""
    want, syms = _frames(4)
    cache = _cpu_cache()
    assert cache.decode(_card_state(), syms[0], FRAMEBITS) is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for n in range(1, 4):
            got = cache.decode(_card_state(), syms[n], FRAMEBITS)
            assert np.array_equal(got, want[n])
            assert counts.only({"acs_regs": n, "tb_walk": n})
            assert _build.ACS_REGS.tally[acs_cuda.WARP_LANES] == n
    plan = cache.plan(CARD, FRAMEBITS)
    assert plan.made == {(_build.ACS_REGS, acs_cuda.WARP_LANES): 1,
                         (_build.TB_WALK, None): 1}
    records = calllog.spans()
    assert [r.name for r in records] == ["ingest", "viterbi",
                                         "readback"] * 3
    for r in records:
        assert r.counters == {
            "ingest": {"h2d_bytes": C.RATE * (FRAMEBITS + C.TAIL_BITS),
                       "staged_chunks": 0},
            "viterbi": {"launches": 2, "acs_lanes": acs_cuda.WARP_LANES},
            "readback": {"d2h_bytes": FRAMEBITS // 8}}[r.name]


def test_a_capture_records_no_launch_outside_its_thread(fake_launches):
    """``recording`` takes only its own thread's launches off the
    tallies: another thread's launch in the meantime is counted."""
    started, resume = threading.Event(), threading.Event()

    def other():
        started.wait(timeout=60)
        _build.TB_WALK.launch(CARD)
        resume.set()
    t = threading.Thread(target=other)
    t.start()
    with _build.recording() as made:
        _build.ACS_REGS.launch(CARD, form=acs_cuda.WARP_LANES)
        started.set()
        assert resume.wait(timeout=60)
    t.join(timeout=60)
    assert not t.is_alive()
    assert made == {(_build.ACS_REGS, acs_cuda.WARP_LANES): 1}
    assert counts.only({"tb_walk": 1})


def test_two_threads_each_get_their_own_frames(fake_launches):
    """Two threads decoding frames of one size at once, the plan taken by
    one and the other sent the eager way whenever it is busy: each gets
    its own frames' bytes, never the other's."""
    want, syms = _frames(8, seed=5)
    cache = _cpu_cache()
    barrier = threading.Barrier(2, timeout=60)
    results = {0: [], 1: []}

    def caller(t):
        barrier.wait()
        for k in range(t, 8, 2):
            got = cache.decode(_card_state(), syms[k], FRAMEBITS)
            if got is None:
                got = acs_cuda.decode(torch.from_numpy(syms[k][None]),
                                      FRAMEBITS)[0].numpy()
            results[t].append((k, got))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(t,))
                   for t in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(k for r in results.values() for k, _ in r) == list(range(8))
    for r in results.values():
        for k, got in r:
            assert np.array_equal(got, want[k])


def test_through_the_api_the_second_call_replays(monkeypatch, fake_launches):
    """Through ``deconvolve``, with a card's rule for the input and a
    stubbed plan: the first call of a size runs eagerly (``graphed`` 0),
    later ones replay (``graphed`` 1) in the same tree of stages, and
    the caller's results are fresh arrays, never the pinned output."""
    monkeypatch.setattr(dispatch.state(), "variant", FUSED)
    rule = frameplan.takes
    monkeypatch.setattr(frameplan, "takes", lambda st, syms, fb: rule(
        _card_state(), syms, fb))
    monkeypatch.setattr(frameplan, "CACHE", _cpu_cache())
    want, syms = _frames(3)
    graphed = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for k in range(3):
            out = np.empty(FRAMEBITS // 8, np.uint8)
            assert viterbi_tpu_torch.deconvolve(FRAMEBITS, syms[k], 0,
                                                out) == 0
            assert np.array_equal(out, want[k])
            assert np.array_equal(viterbi_tpu_torch.last_output(), want[k])
            roots = [r for r in calllog.spans() if r.parent is None]
            graphed.append(roots[-1].counters["graphed"])
            plan = frameplan.CACHE.plan(CARD, FRAMEBITS) if k else None
            if plan is not None:
                assert not np.shares_memory(api.last_output(), plan.out)
    assert graphed == [0, 1, 1]
    by_request = {}
    for r in calllog.spans():
        by_request.setdefault(r.request, []).append(r)
    for recs in by_request.values():
        assert [r.name for r in recs] == ["ingest", "viterbi", "readback",
                                          "api.deconvolve"]


def test_on_the_cpu_the_api_takes_no_plan():
    """With the API on the CPU every call is eager: ``graphed`` 0 and no
    key in the cache."""
    want, syms = _frames(2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for k in range(2):
            assert viterbi_tpu_torch.deconvolve(FRAMEBITS, syms[k]) == 0
            assert np.array_equal(viterbi_tpu_torch.last_output(), want[k])
    roots = [r for r in calllog.spans() if r.parent is None]
    assert [r.counters for r in roots] == [{"graphed": 0}] * 2
    assert _keys(frameplan.CACHE) == []


# --- on the card -------------------------------------------------------------


@pytest.fixture
def card(tmp_path):
    """The API on the card, its plans dropped, spans on (call logging)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a plan is a CUDA graph)")
    dev = torch.device("cuda", torch.cuda.current_device())
    viterbi_tpu_torch.initialize(device=dev)
    assert dispatch.state().variant == FUSED
    calllog.configure(True, False, str(tmp_path / "log"))
    return dev


def _graphed():
    """The ``graphed`` counter of each ``api.deconvolve`` span since the
    last read."""
    return [r.counters["graphed"] for r in calllog.spans(clear=True)
            if r.name == "api.deconvolve"]


@pytest.mark.cuda
@pytest.mark.parametrize("framebits", SIZES)
def test_on_the_card_every_call_equals_golden(framebits, card):
    """First (eager), second (captured and replayed) and later calls of a
    size, noisy frames and wide int32 values, equal golden; so does a
    call sent the eager way while the plan is busy."""
    want, syms = _frames(4, framebits, seed=framebits)
    wide = np.random.default_rng(framebits).integers(
        -2**31, 2**31 - 1, syms.shape[1], dtype=np.int32)
    frames = [*syms, wide]
    wants = [*want, golden.deconvolve(framebits, wide)]
    for k, (s, w) in enumerate(zip(frames, wants)):
        out = np.empty(framebits // 8, np.uint8)
        assert viterbi_tpu_torch.deconvolve(framebits, s, 0, out) == 0
        assert np.array_equal(out, w), f"call {k}"
    assert _graphed() == [0, 1, 1, 1, 1]
    plan = frameplan.CACHE.plan(card, framebits)
    assert (plan.captures, plan.replays) == (1, 4)
    with plan.lock:
        assert viterbi_tpu_torch.deconvolve(framebits, syms[0]) == 0
    assert np.array_equal(viterbi_tpu_torch.last_output(), want[0])
    assert _graphed() == [0]


@pytest.mark.cuda
def test_on_the_card_each_replay_launches_a_and_b_once(card):
    want, syms = _frames(6, 1536, seed=3)
    assert viterbi_tpu_torch.deconvolve(1536, syms[0]) == 0
    counts.zero_launches()
    for k in range(1, 6):
        assert viterbi_tpu_torch.deconvolve(1536, syms[k]) == 0
        assert np.array_equal(viterbi_tpu_torch.last_output(), want[k])
        assert counts.only({"acs_regs": k, "tb_walk": k})
    assert _build.ACS_REGS.tally[acs_cuda.WARP_LANES] == 5
    assert _graphed() == [0, 1, 1, 1, 1, 1]
    assert frameplan.CACHE.stats() == {"plans": 1, "captures": 1,
                                       "replays": 5}


@pytest.mark.cuda
def test_on_the_card_two_threads_on_one_size(card):
    """Two caller threads on one size: each gets its own frames' bytes,
    and the plan served some of the calls."""
    want, syms = _frames(40, 768, seed=11)
    assert viterbi_tpu_torch.deconvolve(768, syms[0]) == 0
    barrier = threading.Barrier(2, timeout=60)
    results = {0: [], 1: []}

    def caller(t):
        barrier.wait()
        for k in range(t, 40, 2):
            out = np.empty(96, np.uint8)
            ret = viterbi_tpu_torch.deconvolve(768, syms[k], 0, out)
            results[t].append((k, ret, out,
                               viterbi_tpu_torch.last_output()))

    threads = [threading.Thread(target=caller, args=(t,)) for t in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for r in results.values():
        assert len(r) == 20
        for k, ret, out, last in r:
            assert ret == 0
            assert np.array_equal(out, want[k]) and np.array_equal(last,
                                                                   want[k])
    assert frameplan.CACHE.stats()["replays"] >= 20


@pytest.mark.cuda
def test_on_the_card_the_fault_latch_holds(card, monkeypatch):
    """The harness's fault injection passes with plans held; a fault in a
    replay returns 1 and latches safe mode; ``initialize()`` re-arms and
    drops every plan."""
    _, syms = _frames(3)
    for k in range(3):
        assert viterbi_tpu_torch.deconvolve(FRAMEBITS, syms[k]) == 0
    assert benchmark.fault_injection_test()
    assert _keys(frameplan.CACHE) == []
    for k in range(2):
        assert viterbi_tpu_torch.deconvolve(FRAMEBITS, syms[k]) == 0
    plan = frameplan.CACHE.plan(card, FRAMEBITS)

    def fault():
        raise RuntimeError("injected replay fault")
    monkeypatch.setattr(plan, "_replay", fault)
    assert viterbi_tpu_torch.deconvolve(FRAMEBITS, syms[2]) == 1
    assert dispatch.state().safe_mode
    assert viterbi_tpu_torch.deconvolve(FRAMEBITS, syms[2]) == 1
    viterbi_tpu_torch.initialize()
    assert _keys(frameplan.CACHE) == [] and not dispatch.state().safe_mode
    assert viterbi_tpu_torch.deconvolve(FRAMEBITS, syms[2]) == 0
