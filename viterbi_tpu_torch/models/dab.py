"""DAB / DAB+ decode chains — the "model" layer, port of
``viterbi_tpu.models.dab``.

The reference exposes two hot primitives (deconvolve +
RScheckSuperframe) and leaves their composition to its caller. Here the
composition is one call, so a whole batch of DAB+ audio superframes
decodes on the device end to end:

    subchannel soft symbols (5 logical frames, 24 ms each)
      -> batched Viterbi deconvolve        (ops.acs_cuda / ops.acs)
      -> pack to bytes, assemble superframe
      -> RS(120,110) check/correct         (ops.rs)
      -> corrected audio superframe bytes + error counts

Shapes follow DAB terminology: a subchannel at ``bitrate`` kbit/s yields
framebits = 24 * bitrate per 24 ms logical frame
(viterbi-benchmark.cpp:56); a DAB+ audio superframe spans 5 logical
frames whose decoded bytes form ``rs_dims = superframe_bytes / 120``
interleaved RS codewords (rschecksf.cpp:58-62).

Symbols go to the device once and every result is a tensor on that
device. A host array goes to the card where there is one, unless the
caller names a device. ``use_kernels=None`` takes the Hopper kernels
(``acs_cuda.decode``: the fused ACS and the checkpoint walk) for symbols
on a CUDA device and the plain path for symbols on the CPU;
``use_kernels=True`` on CPU symbols raises. The sharded ensemble entry
point waits for the port of ``parallel``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .. import constants as C
from ..ops import acs, acs_cuda, rs as rs_ops, traceback
from . import puncture as P

SUPERFRAME_FRAMES = 5  # logical frames per DAB+ audio superframe


@dataclasses.dataclass(frozen=True)
class SubchannelConfig:
    """A DAB subchannel's decode geometry."""
    bitrate_kbps: int                      # 8..384 (old DAB max)

    @property
    def framebits(self) -> int:
        return 24 * self.bitrate_kbps

    @property
    def frame_bytes(self) -> int:
        return self.framebits // 8

    @property
    def superframe_bytes(self) -> int:
        return SUPERFRAME_FRAMES * self.frame_bytes

    @property
    def rs_dims(self) -> int:
        """Interleaved RS codewords per superframe (120 B each)."""
        if self.superframe_bytes % C.RS_N:
            raise ValueError(f"{self.bitrate_kbps} kbit/s does not fill "
                             f"whole RS codewords in a DAB+ superframe")
        return self.superframe_bytes // C.RS_N

    @property
    def symbols_per_frame(self) -> int:
        return C.RATE * (self.framebits + C.TAIL_BITS)


def _on_device(symbols, device) -> torch.Tensor:
    """Symbols as an int32 tensor on the decode device: a tensor stays
    where it is unless ``device`` says otherwise; a host array goes to the
    card where there is one."""
    if isinstance(symbols, torch.Tensor):
        return symbols.to(device=device or symbols.device, dtype=torch.int32)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.from_numpy(np.ascontiguousarray(symbols, dtype=np.int32)) \
        .to(device)


def _use_kernels(use_kernels: bool | None, symbols: torch.Tensor) -> bool:
    on_card = symbols.device.type == "cuda"
    if use_kernels and not on_card:
        raise ValueError("use_kernels=True needs symbols on a CUDA device, "
                         f"got {symbols.device}")
    return on_card if use_kernels is None else bool(use_kernels)


def bytes_to_superframes(frame_bytes: torch.Tensor, cfg: SubchannelConfig):
    """[B, 5, frame_bytes] decoded frame bytes -> [B, superframe_bytes]."""
    return frame_bytes.reshape(frame_bytes.shape[0], cfg.superframe_bytes)


def decode_frames(flat: torch.Tensor, framebits: int, use_kernels: bool,
                  scan: bool = False) -> torch.Tensor:
    """The chains' Viterbi stage: [N, 4*(framebits+6)] int32 symbols ->
    uint8[N, framebits//8]. With kernels, kernel A then kernel B; without,
    ``acs.forward`` and the blocked traceback (``scan``: the serial one,
    as the JAX package decodes punctured frames)."""
    if use_kernels:
        return acs_cuda.decode(flat, framebits)
    decisions, _ = acs.forward(flat, framebits + C.TAIL_BITS)
    if scan:
        return traceback.chainback_scan(decisions, framebits)
    block = next(b for b in (64, 48, 32, 24, 16, 8, 4, 2, 1)
                 if framebits % b == 0)
    return traceback.chainback_blocked(decisions, framebits, block=block)


def rs_superframes(sf: torch.Tensor, rs_dims: int):
    """The chains' RS stage: uint8[B, rs_dims*120] superframes ->
    (audio uint8[B, rs_dims*110], errors int32[B]). Every superframe is
    deinterleaved into its codewords and the whole [B * rs_dims, 120]
    batch decoded at once."""
    B = sf.shape[0]
    blocks = sf.reshape(B, C.RS_N, rs_dims).transpose(1, 2)
    count, corrected = rs_ops.rs_decode_blocks(
        blocks.reshape(B * rs_dims, C.RS_N))
    count = count.reshape(B, rs_dims)
    corrected = corrected.reshape(B, rs_dims, C.RS_N)
    any_fail = (count < 0).any(dim=1)
    errors = torch.where(any_fail, -1, count.sum(dim=1)).to(torch.int32)
    audio = corrected[:, :, :C.RS_KK].transpose(1, 2) \
        .reshape(B, rs_dims * C.RS_KK).to(torch.uint8)
    return audio, errors


def decode_audio_superframes(symbols, bitrate_kbps: int,
                             use_kernels: bool | None = None, device=None):
    """Decode a batch of DAB+ audio superframes end to end on the device.

    ``symbols``: int[B, 5, 4*(framebits+6)] soft symbols for 5 consecutive
    logical frames of one subchannel (already depunctured, as the
    reference expects), a tensor or a host array.

    Returns (audio uint8[B, rs_dims*110], rs_errors int32[B]) on the
    symbols' device: corrected audio superframe bytes and per-superframe
    corrected-byte counts (-1 = uncorrectable, matching
    RScheckSuperframe).
    """
    cfg = SubchannelConfig(bitrate_kbps)
    syms = _on_device(symbols, device)
    B = syms.shape[0]
    flat = syms.reshape(B * SUPERFRAME_FRAMES, -1)
    frame_bytes = decode_frames(flat, cfg.framebits,
                                _use_kernels(use_kernels, syms))
    sf = bytes_to_superframes(
        frame_bytes.reshape(B, SUPERFRAME_FRAMES, cfg.frame_bytes), cfg)
    return rs_superframes(sf, cfg.rs_dims)


def depuncture_device(received: torch.Tensor, mask,
                      index: torch.Tensor | None = None) -> torch.Tensor:
    """Depuncture on the device: [B, n_kept] soft symbols ->
    [B, 4*(I+6)] int32. ``mask`` is a host-side uint8 transmission mask
    (``models.puncture.frame_mask``); punctured positions become the
    neutral soft value. ``index``: the mask's kept positions as an int64
    tensor on the symbols' device, for a caller that keeps it."""
    mask = np.asarray(mask, dtype=bool)
    if index is None:
        index = torch.from_numpy(np.nonzero(mask)[0]).to(received.device)
    out = torch.full((received.shape[0], mask.size), P.NEUTRAL_SOFT,
                     dtype=torch.int32, device=received.device)
    out[:, index] = received.to(torch.int32)
    return out


@lru_cache(maxsize=64)
def _masked_decoder(segments: tuple):
    """Depuncture + decode closure for one profile, cached on the
    profile's small ``segments`` tuple: the mask is built once and its
    index tensor once per device."""
    prof = P.Profile("cached", segments)
    mask = prof.mask().astype(bool)
    kept = np.nonzero(mask)[0]
    framebits = prof.data_bits
    index: dict[torch.device, torch.Tensor] = {}

    def decode(received, use_kernels=None, device=None):
        rec = _on_device(received, device)
        if rec.dim() != 2 or rec.shape[1] != kept.size:
            raise ValueError(f"received must be [B, {kept.size}], "
                             f"got {list(rec.shape)}")
        idx = index.get(rec.device)
        if idx is None:
            idx = index[rec.device] = torch.from_numpy(kept).to(rec.device)
        full = depuncture_device(rec, mask, idx)
        return decode_frames(full, framebits, _use_kernels(use_kernels, rec),
                             scan=True)

    return decode


def decode_punctured_frames(received, bitrate_kbps: int, level: int,
                            profile: str = "A",
                            use_kernels: bool | None = None,
                            device=None) -> torch.Tensor:
    """Decode punctured logical frames of an EEP-protected subchannel.

    ``received``: int[B, transmitted_bits] punctured soft symbols (the
    over-the-air layout). Depunctures to the rate-1/4 mother stream and
    runs the batched Viterbi decode. Returns uint8[B, framebits//8] on the
    symbols' device.
    """
    prof = P.eep_profile(bitrate_kbps, level, profile)
    return _masked_decoder(prof.segments)(received, use_kernels, device)


def decode_profile_frames(received, profile: P.Profile,
                          use_kernels: bool | None = None,
                          device=None) -> torch.Tensor:
    """Decode punctured frames of ANY ``puncture.Profile``, user-supplied
    UEP rows included (``puncture.uep_profile_from_row``).

    ``received``: int[B, profile.transmitted_bits] soft symbols. Returns
    uint8[B, profile.data_bits // 8] on the symbols' device.
    """
    return _masked_decoder(profile.segments)(received, use_kernels, device)
