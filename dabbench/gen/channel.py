"""The benchmark's signal generator: DAB+ audio superframes and plain
frames, encoded, punctured, sent through AWGN and depunctured, made on the
device from a ``torch.Generator``.

Frozen copies, so that the yardstick cannot move with the program:

* the channel (offset-binary soft symbols around 127.5, gain 32, clipped
  to [0, 255]; noise by Eb/N0 with the code rate's adjustment) and the
  terminated K=7 rate-1/4 encoder: ``viterbi_tpu_torch/harness/channel.py``
  (``soft_on_device``, ``hard_on_device``, ``make_superframes``) at commit
  7d07b678fb927d24a3ae9bba69ca509c72acf088, the reference benchmark's AWGN
  model (viterbi-benchmark.cpp:58-65, 293-311);
* the systematic RS(120,110) encoder: ``golden.rs_encode_many`` of the
  same package and commit, here in torch over many messages at once;
* the EEP puncturing vectors and tables (EN 300 401 tables 33/34):
  ``viterbi_tpu_torch/models/puncture.py`` at the same commit.

Where the copy departs from the originals: the noise is drawn only for the
transmitted (unpunctured) symbols, at the Eb/N0 of the stated code rate,
and the punctured positions are filled with the neutral value 127 (the
receiver's depuncturing, which the reference DLL expects done upstream).
Imports torch and numpy only.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

K = 7
RATE = 4
POLYS = (109, 79, 83, 109)
TAIL_BITS = K - 1
RS_N, RS_KK, RS_NROOTS = 120, 110, 10
SUPERFRAME_FRAMES = 5
#: frames whose symbols are made in one go (bounds the temporaries)
_CHUNK_SYMBOLS = 1 << 26

# --------------------------------------------------------------------------
# EEP puncturing (copied from models/puncture.py)
# --------------------------------------------------------------------------

_GROUP_ORDER = (0, 4, 2, 6, 1, 5, 3, 7)
TAIL_VECTOR = np.tile(np.array([1, 1, 0, 0], dtype=np.uint8), 6)


@functools.lru_cache(maxsize=1)
def puncturing_vectors() -> np.ndarray:
    """uint8[25, 32]: row PI keeps 8 + PI of 32 bits (row 0 the base)."""
    vec = np.zeros((25, 32), dtype=np.uint8)
    vec[:, 0::4] = 1
    fills = [(col, g) for col in (1, 2, 3) for g in _GROUP_ORDER]
    for pi in range(1, 25):
        vec[pi] = vec[pi - 1]
        col, g = fills[pi - 1]
        vec[pi, 4 * g + col] = 1
    return vec


def eep_segments(bitrate_kbps: int, level: int, profile: str = "A"):
    """((blocks, PI), ...) of an EEP profile (EN 300 401 tables 33/34)."""
    if profile == "A":
        n = bitrate_kbps // 8
        if bitrate_kbps % 8:
            raise ValueError("EEP-A needs a multiple of 8 kbit/s")
        if level == 2 and n == 1:
            return ((5, 13), (1, 12))
        return {1: ((6 * n - 3, 24), (3, 23)),
                2: ((2 * n - 3, 14), (4 * n + 3, 13)),
                3: ((6 * n - 3, 8), (3, 7)),
                4: ((4 * n - 3, 3), (2 * n + 3, 2))}[level]
    if profile == "B":
        n = bitrate_kbps // 32
        if bitrate_kbps % 32:
            raise ValueError("EEP-B needs a multiple of 32 kbit/s")
        pi1 = {1: 10, 2: 6, 3: 4, 4: 2}[level]
        return ((24 * n - 3, pi1), (3, pi1 - 1))
    raise ValueError(f"unknown EEP profile {profile!r}")


@functools.lru_cache(maxsize=64)
def eep_mask(bitrate_kbps: int, level: int, profile: str = "A") -> np.ndarray:
    """bool[4 * (framebits + 6)]: the transmitted mother-code positions."""
    vec = puncturing_vectors()
    segs = eep_segments(bitrate_kbps, level, profile)
    mask = np.concatenate([np.tile(vec[pi], 4 * blocks)
                           for blocks, pi in segs] + [TAIL_VECTOR])
    if mask.size != RATE * (24 * bitrate_kbps + TAIL_BITS):
        raise ValueError(f"EEP {level}-{profile} does not cover "
                         f"{bitrate_kbps} kbit/s")
    return mask.astype(bool)


# --------------------------------------------------------------------------
# RS(120,110) systematic encoder (golden.rs_encode_many, in torch)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _gf_np():
    alpha = np.zeros(256, np.int64)
    log = np.zeros(256, np.int64)
    log[0] = 255
    sr = 1
    for i in range(255):
        log[sr], alpha[i] = i, sr
        sr <<= 1
        if sr & 0x100:
            sr ^= 0x11D
    a = np.arange(256)
    mul = alpha[(log[a][:, None] + log[a][None, :]) % 255]
    mul[(a[:, None] == 0) | (a[None, :] == 0)] = 0
    g = np.zeros(RS_NROOTS + 1, np.int64)
    g[0] = 1
    for i in range(RS_NROOTS):                 # g(x) = prod (x - alpha^i)
        g = np.concatenate([[0], g[:-1]]) ^ mul[g, alpha[i]]
    return mul, g[:RS_NROOTS][::-1].copy()


def rs_encode(msgs: torch.Tensor) -> torch.Tensor:
    """uint8[N, 110] messages -> uint8[N, 120] codewords (10 parity bytes
    appended, LFSR division by the generator polynomial)."""
    mul_np, taps_np = _gf_np()
    dev = msgs.device
    mul = torch.from_numpy(mul_np).to(dev).reshape(-1)
    taps = torch.from_numpy(taps_np).to(dev)
    m = msgs.to(torch.int64)
    rem = torch.zeros((m.shape[0], RS_NROOTS), dtype=torch.int64, device=dev)
    for j in range(RS_KK):
        fb = rem[:, 0] ^ m[:, j]
        rem = torch.cat([rem[:, 1:], torch.zeros_like(rem[:, :1])], dim=1)
        rem ^= mul[taps[None, :] * 256 + fb[:, None]]
    return torch.cat([m, rem], dim=1).to(torch.uint8)


# --------------------------------------------------------------------------
# Encoder and channel (harness/channel.py's device half)
# --------------------------------------------------------------------------

_PARITY7 = np.array([bin(x).count("1") & 1 for x in range(128)], np.int64)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """int [B, n] data bits -> int64 [B, 4 * (n + 6)] hard symbols of the
    terminated mother code (six zero tail bits)."""
    b = bits.to(torch.int64)
    B, n = b.shape
    z = torch.zeros((B, TAIL_BITS), dtype=torch.int64, device=b.device)
    ext, steps = torch.cat([z, b, z], dim=1), n + TAIL_BITS
    sr = torch.zeros((B, steps), dtype=torch.int64, device=b.device)
    for k in range(K):           # register bit k holds the bit k steps back
        sr |= ext[:, TAIL_BITS - k: TAIL_BITS - k + steps] << k
    parity = torch.from_numpy(_PARITY7).to(b.device)
    return torch.stack([parity[sr & p] for p in POLYS], dim=2) \
        .reshape(B, RATE * steps)


def noise_amplitude(ebn0_db: float, code_rate: float) -> float:
    """Signal amplitude for unit-variance noise: Es/N0 = Eb/N0 + 10 log10
    of the code rate (the reference's ``esn0 = ebn0 + 10*log10(1/RATE)``
    for the unpunctured mother code)."""
    esn0 = ebn0_db + 10.0 * math.log10(code_rate)
    return 1.0 / math.sqrt(0.5 / 10.0 ** (esn0 / 10.0))


def channel(hard: torch.Tensor, signal: dict, gen: torch.Generator,
            keep: torch.Tensor | None) -> torch.Tensor:
    """Hard symbols -> int32 soft symbols as the receiver hands them on:
    the kept positions (``keep``: their indices, or None for all) through
    AWGN at the signal's Eb/N0, gain and offset, clipped; the punctured
    ones set to the neutral value."""
    num, den = signal["code_rate"]
    amp = noise_amplitude(signal["ebn0_db"], num / den)
    sent = hard if keep is None else hard[:, keep]
    soft = torch.randn(sent.shape, generator=gen, device=hard.device)
    soft += torch.where(sent != 0, amp, -amp)
    soft = (signal["offset"] + signal["gain"] * soft) \
        .clamp_(0, signal["clip"]).to(torch.int32)
    if keep is None:
        return soft
    out = torch.full(hard.shape, signal["neutral"], dtype=torch.int32,
                     device=hard.device)
    out[:, keep] = soft
    return out


def _keep(signal: dict, kbps: int, device) -> torch.Tensor | None:
    prot = signal.get("protection")
    if not prot:
        return None
    mask = eep_mask(kbps, prot["level"], prot["profile"])
    return torch.from_numpy(np.nonzero(mask)[0]).to(device)


def frames_to_symbols(bits: torch.Tensor, signal: dict, kbps: int | None,
                      gen: torch.Generator) -> torch.Tensor:
    """int [B, framebits] data bits -> int32 [B, 4 * (framebits + 6)]
    received soft symbols, made in chunks of frames."""
    B, framebits = bits.shape
    keep = _keep(signal, kbps, bits.device) if kbps else None
    width = RATE * (framebits + TAIL_BITS)
    out = torch.empty((B, width), dtype=torch.int32, device=bits.device)
    step = max(1, _CHUNK_SYMBOLS // width)
    for i in range(0, B, step):
        out[i:i + step] = channel(conv_encode(bits[i:i + step]), signal,
                                  gen, keep)
    return out


def rs_dims_of(kbps: int) -> int:
    """Interleaved codewords of a DAB+ superframe at ``kbps``."""
    sf_bytes = SUPERFRAME_FRAMES * 24 * kbps // 8
    if sf_bytes % RS_N:
        raise ValueError(f"{kbps} kbit/s does not fill whole RS codewords")
    return sf_bytes // RS_N


def make_superframes(n: int, kbps: int, signal: dict, gen: torch.Generator,
                     bad: torch.Tensor, device):
    """``n`` DAB+ audio superframes of one subchannel: random audio ->
    RS(120,110) -> byte interleave -> bits -> encoder, puncturing, AWGN ->
    depunctured soft symbols. Superframes where ``bad`` (bool[n]) is set
    get nine byte errors in one codeword before the encoder, more than RS
    corrects. Returns (sent uint8[n, rs_dims*120], the interleaved
    superframes as sent; symbols int32[n, 5, 4*(framebits+6)])."""
    rs_dims = rs_dims_of(kbps)
    framebits = 24 * kbps
    audio = torch.randint(0, 256, (n * rs_dims, RS_KK), generator=gen,
                          device=device, dtype=torch.int64)
    cws = rs_encode(audio).reshape(n, rs_dims, RS_N)
    for i in torch.nonzero(bad).flatten().tolist():
        j = int(torch.randint(0, rs_dims, (1,), generator=gen,
                              device=device))
        pos = torch.randperm(RS_N, generator=gen, device=device)[:9]
        val = torch.randint(1, 256, (9,), generator=gen, device=device,
                            dtype=torch.int64).to(torch.uint8)
        cws[i, j, pos] ^= val
    sent = cws.transpose(1, 2).reshape(n, rs_dims * RS_N).contiguous()
    shifts = torch.arange(7, -1, -1, device=device)
    bits = ((sent[..., None].to(torch.int64) >> shifts) & 1) \
        .reshape(n * SUPERFRAME_FRAMES, framebits)
    syms = frames_to_symbols(bits, signal, kbps, gen)
    return sent, syms.reshape(n, SUPERFRAME_FRAMES, -1)


def make_frames(n: int, framebits: int, signal: dict, gen: torch.Generator,
                device):
    """``n`` random frames of ``framebits``: (bits int64[n, framebits],
    symbols int32[n, 4*(framebits+6)])."""
    bits = torch.randint(0, 2, (n, framebits), generator=gen, device=device,
                         dtype=torch.int64)
    kbps = framebits // 24 if signal.get("protection") else None
    return bits, frames_to_symbols(bits, signal, kbps, gen)
