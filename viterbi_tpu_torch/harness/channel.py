"""Loopback test channel: encoder + AWGN, the methodology twin of the
reference benchmark's self-checking loop (viterbi-benchmark.cpp:293-329).

Soft symbols are offset-binary around 127.5 with gain 32 and clipping to
[0, 255]; the noise standard deviation follows Eb/N0 with the rate
adjustment ``esn0 = ebn0 + 10*log10(1/RATE)``. The frames are identical
to ``viterbi_tpu.harness.channel.make_frames`` for the same seed: the
same numpy generator is drawn in the same order (all data bits first,
then each frame's noise in frame order). Only the encoder differs: it is
vectorized over frames and steps, since the golden per-bit loop takes
minutes at production batch sizes.

``hard_on_device``, ``soft_on_device`` and ``bit_errors_on_device`` do the
same on a card for batches too large to make on the host in time: the
same encoder and channel, drawn from a torch generator (so not the numpy
draws of ``make_frames``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from .. import golden
from ..reference import punctured as ref_punctured
from ..reference import tdmb as ref_tdmb

EBN0_DB = 3.0      # reference operating point (viterbi-benchmark.cpp:60)
GAIN = 32.0
OFFSET = 127.5
CLIP = 255

# parity of every 7-bit shift-register value
_PARITY7 = np.array([bin(x).count("1") & 1 for x in range(128)],
                    dtype=np.uint8)
# frames per noise draw: bounds the float64 temporaries to ~32 MiB
_NOISE_CHUNK_SYMBOLS = 1 << 22


def noise_amplitude(ebn0_db: float = EBN0_DB, rate: int = C.RATE) -> float:
    """Signal amplitude for unit-variance noise at the given Eb/N0."""
    esn0 = ebn0_db + 10.0 * np.log10(1.0 / rate)
    return 1.0 / np.sqrt(0.5 / 10.0 ** (esn0 / 10.0))


def encode_batch(bits: np.ndarray) -> np.ndarray:
    """Encode uint8[B, framebits] data bits -> uint8[B, 4*(framebits+6)]
    hard symbols, tail-terminated; frame for frame equal to
    ``golden.encode``."""
    bits = np.asarray(bits, dtype=np.uint8)
    B, framebits = bits.shape
    nsteps = framebits + C.TAIL_BITS
    z = np.zeros((B, C.TAIL_BITS), dtype=np.uint8)
    padded = np.concatenate([z, bits, z], axis=1).astype(np.int32)
    # shift register at step t holds bits t-6..t, newest in bit 0
    sr = np.zeros((B, nsteps), dtype=np.int32)
    for i in range(C.K):
        sr |= padded[:, C.TAIL_BITS - i: C.TAIL_BITS - i + nsteps] << i
    hard = np.stack([_PARITY7[sr & poly] for poly in C.POLYS], axis=2)
    return hard.reshape(B, C.RATE * nsteps)


def awgn_soft_symbols(hard: np.ndarray, rng: np.random.Generator,
                      ebn0_db: float = EBN0_DB) -> np.ndarray:
    """Map hard symbols {0,1} to noisy soft symbols uint32 in [0, 255]."""
    amp = noise_amplitude(ebn0_db)
    hard = np.asarray(hard)
    mean = np.where(hard != 0, amp, -amp)
    sample = OFFSET + GAIN * (mean + rng.standard_normal(hard.shape))
    return np.clip(sample, 0, CLIP).astype(np.uint32)


def make_frames(nframes: int, framebits: int, seed: int = 0,
                ebn0_db: float = EBN0_DB):
    """Generate (data_bits, soft_symbols) for ``nframes`` random frames.

    Returns ``bits``  uint8[nframes, framebits]   original data bits and
            ``syms``  uint32[nframes, 4*(framebits+6)] noisy soft symbols.
    """
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(nframes, framebits), dtype=np.uint8)
    width = C.RATE * (framebits + C.TAIL_BITS)
    syms = np.empty((nframes, width), dtype=np.uint32)
    step = max(1, _NOISE_CHUNK_SYMBOLS // width)
    for i in range(0, nframes, step):
        # one (n, width) draw consumes the generator exactly as n
        # consecutive per-frame draws do
        syms[i:i + step] = awgn_soft_symbols(
            encode_batch(bits[i:i + step]), rng, ebn0_db)
    return bits, syms


def make_superframes(n: int, bitrate_kbps: int, seed: int = 0,
                     ebn0_db: float = EBN0_DB, uncorrectable: int = 0):
    """Generate ``n`` DAB+ audio superframes of one subchannel: random
    audio -> RS(120,110) -> byte interleave -> bits -> encoder + AWGN.

    The first ``uncorrectable`` superframes get nine byte errors in one
    codeword before the convolutional encoder (more than RS corrects), so
    the -1 path occurs whatever the noise does.

    Returns ``audio`` uint8[n, rs_dims, 110], the encoded data bytes per
    codeword, and ``syms`` int32[n, 5, 4*(framebits+6)] soft symbols of
    the superframe's five logical frames.
    """
    framebits = 24 * bitrate_kbps
    rs_dims = 5 * framebits // (8 * C.RS_N)
    if rs_dims * 8 * C.RS_N != 5 * framebits:
        raise ValueError(f"{bitrate_kbps} kbit/s does not fill whole RS "
                         f"codewords in a DAB+ superframe")
    rng = np.random.default_rng(seed)
    audio = rng.integers(0, 256, (n, rs_dims, C.RS_KK), dtype=np.uint8)
    cws = golden.rs_encode_many(audio.reshape(-1, C.RS_KK)) \
        .reshape(n, rs_dims, C.RS_N)
    for i in range(min(uncorrectable, n)):
        pos = rng.choice(C.RS_N, 9, replace=False)
        cws[i, rng.integers(rs_dims), pos] ^= \
            rng.integers(1, 256, 9).astype(np.uint8)
    sf = cws.transpose(0, 2, 1).reshape(n, rs_dims * C.RS_N)
    bits = np.unpackbits(sf, axis=1).reshape(n * 5, framebits)
    width = C.RATE * (framebits + C.TAIL_BITS)
    syms = np.empty((n * 5, width), dtype=np.int32)
    step = max(1, _NOISE_CHUNK_SYMBOLS // width)
    for i in range(0, n * 5, step):
        syms[i:i + step] = awgn_soft_symbols(
            encode_batch(bits[i:i + step]), rng, ebn0_db)
    return audio, syms.reshape(n, 5, width)


def make_ts_streams(n_streams: int, cifs: int, bitrate_kbps: int,
                    seed: int = 0, esn0_db: float = -1.0, bad=(),
                    protection=("A", 3)) -> np.ndarray:
    """Punctured soft bytes uint8[n_streams, cifs, kept] of T-DMB transport
    streams at ``bitrate_kbps`` (68 p kbit/s, p packets a CIF): random
    188-byte messages -> RS(204,188) (12 byte errors in each packet
    index of ``bad``) -> the I = 12 interleaver from zeros -> bits ->
    encoder -> ``protection``'s puncturing -> AWGN at ``esn0_db`` on
    every sent symbol. The outer code and interleaver are the plain
    reference's (``reference.tdmb``), the masks ``reference.punctured``'s.
    """
    rng = np.random.default_rng(seed)
    framebits = 24 * bitrate_kbps
    p = framebits // 8 // ref_tdmb.N
    keep = ref_punctured.mask(bitrate_kbps, protection).numpy()
    out = []
    for _ in range(n_streams):
        msgs = rng.integers(0, 256, (cifs * p, ref_tdmb.K), dtype=np.uint8)
        cws = np.stack([ref_tdmb.rs_encode(m) for m in msgs])
        for m in bad:
            pos = rng.choice(ref_tdmb.N, 12, replace=False)
            cws[m, pos] ^= rng.integers(1, 256, 12).astype(np.uint8)
        bits = np.unpackbits(ref_tdmb.interleave(cws.reshape(-1))) \
            .reshape(cifs, framebits)
        soft = awgn_soft_symbols(encode_batch(bits), rng,
                                 ebn0_db=esn0_db + 10.0 * np.log10(C.RATE))
        out.append(soft[:, keep].astype(np.uint8))
    return np.stack(out)


def ber_fer(decoded_bytes: np.ndarray, bits: np.ndarray):
    """Bit/frame error rates of packed decode output vs original bits.

    ``decoded_bytes``: uint8[nframes, framebits//8] MSB-first packed.
    Returns (ber, fer, total bit errors).
    """
    nframes, framebits = bits.shape
    ref = np.packbits(bits, axis=1)
    diff = np.unpackbits(decoded_bytes ^ ref, axis=1)
    bit_errs = diff.sum(axis=1)
    ber = bit_errs.sum() / (nframes * framebits)
    fer = np.count_nonzero(bit_errs) / nframes
    return float(ber), float(fer), int(bit_errs.sum())


def hard_on_device(bits: torch.Tensor, tailbiting: bool = False):
    """Hard symbols made where int ``bits`` [B, n] lie: terminated (n + 6
    steps, a zero tail; ``encode_batch``) or tail-biting (n steps, the
    register preloaded with the last six bits; ``golden.encode_tailbiting``).
    Returns int [B, 4 * steps] of 0 and 1."""
    b = bits.to(torch.int32)
    B, n = b.shape
    if tailbiting:
        ext, steps = torch.cat([b[:, -C.TAIL_BITS:], b], dim=1), n
    else:
        z = torch.zeros((B, C.TAIL_BITS), dtype=torch.int32, device=b.device)
        ext, steps = torch.cat([z, b, z], dim=1), n + C.TAIL_BITS
    sr = torch.zeros((B, steps), dtype=torch.int32, device=b.device)
    for k in range(C.K):      # register bit k holds the bit k steps back
        sr |= ext[:, C.TAIL_BITS - k: C.TAIL_BITS - k + steps] << k
    parity = torch.as_tensor(_PARITY7, device=b.device)
    return torch.stack([parity[(sr & p).long()] for p in C.POLYS],
                       dim=2).reshape(B, C.RATE * steps)


def soft_on_device(bits: torch.Tensor, tailbiting: bool, gen: torch.Generator,
                   ebn0_db: float = EBN0_DB) -> torch.Tensor:
    """``hard_on_device``'s symbols through this channel's AWGN at
    ``ebn0_db``, the noise drawn from ``gen`` where ``bits`` lie: int32
    [B, 4 * steps] soft symbols."""
    hard = hard_on_device(bits, tailbiting)
    amp = noise_amplitude(ebn0_db)
    soft = torch.randn(hard.shape, generator=gen, device=hard.device)
    soft += torch.where(hard != 0, amp, -amp)
    del hard
    soft = (OFFSET + GAIN * soft).clamp_(0, CLIP)
    return soft.to(torch.int32)


def bit_errors_on_device(decoded: torch.Tensor, bits: torch.Tensor) -> int:
    """Bit errors of MSB-first decoded bytes against the int ``bits`` [B,
    n] they should carry, counted where they lie."""
    from ..ops import traceback as tb
    pop = torch.tensor([bin(i).count("1") for i in range(256)],
                       device=decoded.device)
    return int(pop[(decoded ^ tb.packbits_msb(bits)).long()].sum())
