"""The port's device rule: every entry point decodes on the card unless the
caller asks for the CPU, and raises ``NoDeviceError`` where there is no
card; the API's dispatcher is set up at first use, once, and keeps the
device it was given. With the CPU asked for, the API equals the JAX
package's bit for bit (tolerance zero).
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import viterbi_tpu
import viterbi_tpu_torch
from viterbi_tpu.runtime import config as jax_config
from viterbi_tpu_torch import constants as C
from viterbi_tpu_torch import golden
from viterbi_tpu_torch.harness import benchmark
from viterbi_tpu_torch.models import dab
from viterbi_tpu_torch.models import puncture as P
from viterbi_tpu_torch.ops import counts, tailbiting
from viterbi_tpu_torch.parallel import StreamSession, streaming
from viterbi_tpu_torch.runtime import config as config_mod
from viterbi_tpu_torch.runtime import dispatch
from viterbi_tpu_torch.runtime.placement import NoDeviceError
from viterbi_tpu_torch.utils import pipeline

FRAMEBITS = 768
BATCH = 8
RS_DIMS = 4


@pytest.fixture(autouse=True)
def _fresh_config(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "port.txt"))
    jax_cfg = tmp_path / "jax.txt"
    jax_cfg.write_text("a:0\ncompile_cache=0\n")
    monkeypatch.setenv(jax_config.CONFIG_ENV, str(jax_cfg))


@pytest.fixture
def unset(monkeypatch):
    """A dispatcher that nothing has set up yet, as at import; the
    process's own comes back after the test."""
    monkeypatch.setattr(dispatch, "_STATE", dispatch.DispatchState())
    return dispatch.state


@pytest.fixture
def no_card(unset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _inputs():
    """Seed 0: 8 noisy frames of 768 bits, and a 4-codeword
    superframe whose codeword 2 has six byte errors (uncorrectable) and
    codeword 0 two."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (BATCH, FRAMEBITS), dtype=np.uint8)
    syms = np.stack([golden.hard_to_soft(golden.encode(b)) for b in bits])
    syms = np.clip(syms.astype(np.int32)
                   + rng.integers(-60, 61, syms.shape), 0, 255)
    msgs = rng.integers(0, 256, (RS_DIMS, C.RS_KK), dtype=np.uint8)
    cws = golden.rs_encode_many(msgs).astype(np.int64)
    for i, e in enumerate((2, 0, 6, 0)):
        if e:
            pos = rng.choice(C.RS_N, e, replace=False)
            cws[i, pos] ^= rng.integers(1, 256, e)
    sf = cws.T.reshape(-1).astype(np.uint8)
    return syms.astype(np.int32), sf


def _sf_symbols(kbps):
    cfg = dab.SubchannelConfig(kbps)
    n = dab.SUPERFRAME_FRAMES * C.RATE * (cfg.framebits + C.TAIL_BITS)
    return np.zeros((1, n), dtype=np.int32)


def _punctured():
    return np.zeros((1, P.eep_profile(32, 3).transmitted_bits),
                    dtype=np.int32)


ENTRY_POINTS = {
    "deconvolve": lambda: viterbi_tpu_torch.deconvolve(
        48, np.zeros(C.RATE * 54, np.int32)),
    "deconvolve_batch": lambda: viterbi_tpu_torch.deconvolve_batch(
        48, np.zeros((2, C.RATE * 54), np.int32)),
    "rs_check_superframe": lambda: viterbi_tpu_torch.rs_check_superframe(
        np.zeros(C.RS_N, np.uint8), 0, 1),
    "wake_up": lambda: viterbi_tpu_torch.wake_up(48),
    "get_caps": viterbi_tpu_torch.get_caps,
    "decode_audio_superframes": lambda: dab.decode_audio_superframes(
        _sf_symbols(32), 32),
    "decode_punctured_frames": lambda: dab.decode_punctured_frames(
        _punctured(), 32, 3),
    "decode_profile_frames": lambda: dab.decode_profile_frames(
        _punctured(), P.eep_profile(32, 3)),
    "decode_tailbiting": lambda: tailbiting.decode_tailbiting(
        np.zeros((1, C.RATE * 96), np.int32), 96),
    "make_local_stream_decoder": lambda: streaming.make_local_stream_decoder(
        1536, 2)(np.zeros((1, C.RATE * 1536), np.int32),
                 np.zeros((1, C.RATE * C.TAIL_BITS), np.int32)),
    "StreamSession": lambda: StreamSession(2),
    "decode_pipelined": lambda: next(pipeline.decode_pipelined(
        [np.zeros(4, np.int32)], lambda t: t)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_card_raises(name, no_card):
    with pytest.raises(NoDeviceError, match="device='cpu'"):
        ENTRY_POINTS[name]()
    st = dispatch.state()
    assert not st.safe_mode and st.except_counter == 0
    assert st.device is None                      # nothing was set up


def test_harness_cli_without_card_raises(no_card):
    with pytest.raises(NoDeviceError, match="--device cpu"):
        benchmark.main(["/f", "100", "/t", "10", "/not"])
    assert not dispatch.state().safe_mode


def test_initialize_without_card_raises_and_cpu_is_kept(no_card):
    with pytest.raises(NoDeviceError):
        viterbi_tpu_torch.initialize()
    assert viterbi_tpu_torch.initialize(device="cpu")
    assert dispatch.state().device == torch.device("cpu")
    assert viterbi_tpu_torch.initialize()         # keeps the CPU
    assert dispatch.state().device == torch.device("cpu")
    assert dispatch.VARIANTS[dispatch.state().variant] == "torch_blocked"


def test_cpu_asked_for_equals_jax(unset):
    syms, sf = _inputs()
    viterbi_tpu.initialize()
    viterbi_tpu_torch.initialize(device="cpu")
    r1, want = viterbi_tpu.deconvolve_batch(FRAMEBITS, syms)
    r2, got = viterbi_tpu_torch.deconvolve_batch(FRAMEBITS, syms)
    assert r1 == r2 == 0 and got.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    want_out = np.full(RS_DIMS * C.RS_KK, 0xEE, dtype=np.uint8)
    got_out = want_out.copy()
    want_ret = viterbi_tpu.rs_check_superframe(sf, 0, RS_DIMS, want_out)
    got_ret = viterbi_tpu_torch.rs_check_superframe(sf, 0, RS_DIMS, got_out)
    assert got_ret == want_ret == -1
    assert got_out.tobytes() == want_out.tobytes()
    assert not dispatch.state().safe_mode
    assert dispatch.state().device == torch.device("cpu")


def test_fault_injection_keeps_the_cpu(unset):
    viterbi_tpu_torch.initialize(device="cpu")
    assert benchmark.fault_injection_test()
    st = dispatch.state()
    assert st.device == torch.device("cpu") and not st.safe_mode
    # the tuner's write-back and select_variant re-arm on the same device
    benchmark.select_variant(0)
    assert st.device == torch.device("cpu")
    assert dispatch.VARIANTS[st.variant] == "torch_scan"


def test_concurrent_first_calls_set_up_once(unset, monkeypatch):
    real = dispatch.setup
    calls = []

    def counted(config_path=None, device=None):
        calls.append(device)
        time.sleep(0.05)          # the others reach ready() meanwhile
        return real(config_path, "cpu" if device is None else device)

    monkeypatch.setattr(dispatch, "setup", counted)
    syms, _ = _inputs()
    start = threading.Barrier(8)
    results = [None] * 8

    def first_call(i):
        start.wait()
        results[i] = viterbi_tpu_torch.deconvolve_batch(FRAMEBITS, syms)

    threads = [threading.Thread(target=first_call, args=(i,))
               for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    want = golden.deconvolve_many(FRAMEBITS, syms[:2])
    for ret, out in results:
        assert ret == 0 and np.array_equal(out[:2], want)
        assert np.array_equal(out, results[0][1])


def test_first_use_with_a_card_picks_cuda_fused(unset, monkeypatch):
    """With a card reported, the first export call sets up cuda_fused on
    the current card; nothing is launched."""
    full = dispatch.CAP_TORCH | dispatch.CAP_BLOCKED_TB \
        | dispatch.CAP_CUDA | dispatch.CAP_KERNELS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(dispatch, "get_caps", lambda root=None: full)
    counts.zero_launches()
    assert viterbi_tpu_torch.get_caps() == full
    st = dispatch.state()
    assert dispatch.VARIANTS[st.variant] == "cuda_fused"
    assert st.device == torch.device("cuda", 0)
    viterbi_tpu_torch.initialize()                # a re-arm keeps the card
    assert st.device == torch.device("cuda", 0)
    assert not any(counts.launches().values())
