"""``deconvolve_batch`` on a resident batch: an int32 torch tensor, unpacked
or packed, decoded where it lies through the selected rung, with no copy
up and no ``ingest`` stage, its bytes back on the host with return code 0,
equal to the host array's call and to golden; the root span counts
``resident``. The ``cuda`` tests hold the card's resident call to the
host array's call and skip without a card.

    python -m pytest tests/test_torch_resident.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import viterbi_tpu_torch
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import channel
from viterbi_tpu_torch.ops import acs_cuda
from viterbi_tpu_torch.runtime import calllog, dispatch
from viterbi_tpu_torch.runtime import config as config_mod

RUNGS = ("torch_scan", "torch_blocked", "cuda_words", "cuda_fused")
#: on the byte and 24-bit window grids, on the byte grid only, off it
FRAMEBITS = (192, 64, 50)


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    viterbi_tpu_torch.initialize(device="cpu")
    calllog.spans(clear=True)
    yield
    calllog.configure(False)
    calllog.spans(clear=True)
    viterbi_tpu_torch.initialize()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the resident batch lies on the "
                    "card, kernels A and B run there)")
    return torch.device("cuda", 0)


def _frames(framebits, n=3):
    _, syms = channel.make_frames(n, framebits, seed=framebits + 5)
    return syms.astype(np.int32)


def _select(rung):
    dispatch.state().variant = dispatch.VARIANTS.index(rung)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("framebits", FRAMEBITS)
@pytest.mark.parametrize("packed", [False, True])
def test_a_resident_batch_equals_the_host_call_and_golden(framebits, rung,
                                                          packed):
    syms = _frames(framebits)
    data = acs_cuda.pack_symbols_host(syms) if packed else syms
    _select(rung)
    r_host, want = viterbi_tpu_torch.deconvolve_batch(framebits, data,
                                                      packed=packed)
    r_res, got = viterbi_tpu_torch.deconvolve_batch(
        framebits, torch.from_numpy(data), packed=packed)
    assert r_host == r_res == 0
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    if framebits % 8 == 0:
        assert np.array_equal(got, golden.deconvolve_many(framebits, syms))


def test_a_resident_batch_has_no_ingest_stage_and_counts_resident():
    syms = _frames(192)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        viterbi_tpu_torch.deconvolve_batch(192, torch.from_numpy(syms))
        viterbi_tpu_torch.deconvolve_batch(192, syms)
    roots = [r for r in calllog.spans() if r.parent is None]
    assert [r.counters.get("resident") for r in roots] == [1, 0]
    first = [r.name for r in calllog.spans()
             if r.request == roots[0].request and r.parent is not None]
    second = [r.name for r in calllog.spans()
              if r.request == roots[1].request and r.parent is not None]
    assert first == ["viterbi", "readback"]
    assert second == ["ingest", "viterbi", "readback"]


def test_a_resident_batch_of_another_type_or_shape_is_refused():
    syms = torch.from_numpy(_frames(192))
    ret, out = viterbi_tpu_torch.deconvolve_batch(192, syms.to(torch.int64))
    assert (ret, out) == (1, None)
    viterbi_tpu_torch.initialize(device="cpu")      # re-arm the latch
    ret, out = viterbi_tpu_torch.deconvolve_batch(192, syms[:, :100])
    assert (ret, out) == (1, None)
    viterbi_tpu_torch.initialize(device="cpu")
    assert viterbi_tpu_torch.deconvolve_batch(192, syms)[0] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("fb", [3072, 9216, 50])
def test_on_the_card_a_resident_batch_equals_the_host_call(cuda, fb, packed):
    viterbi_tpu_torch.initialize(device=cuda)
    syms = _frames(fb, n=33)
    data = acs_cuda.pack_symbols_host(syms) if packed else syms
    r_host, want = viterbi_tpu_torch.deconvolve_batch(fb, data,
                                                      packed=packed)
    r_res, got = viterbi_tpu_torch.deconvolve_batch(
        fb, torch.from_numpy(data).to(cuda), packed=packed)
    assert r_host == r_res == 0
    assert np.array_equal(got, want)
    if fb % 8 == 0:
        assert np.array_equal(got, golden.deconvolve_many(fb, syms))
