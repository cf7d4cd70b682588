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
caller names a device; the superframe chain's goes through
``placement.ingest_words``, which narrows a large batch to packed words
on its way. Punctured symbols (the superframe chain with a
``protection``, and the punctured-frame decoders) go through
``placement.ingest_bytes`` and are depunctured on the device into the
same packed words (``ops.depuncture``, kernel J on a card).
``use_kernels=None`` takes the Hopper kernels
(``acs_cuda.decode``: the fused ACS and the checkpoint walk; in the
superframe chain also kernel I, the RS stage in one launch) for symbols
on a CUDA device and the plain path for symbols on the CPU;
``use_kernels=True`` on CPU symbols raises. ``decode_ensemble_sharded``
runs the chain data-parallel over the ranks of a mesh
(``parallel.mesh``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..ops import acs, acs_cuda, counts, rs as rs_ops, traceback
from ..ops import depuncture as depuncture_ops
from ..parallel import distributed
from ..parallel import mesh as mesh_mod
from ..runtime import calllog
from ..runtime.placement import on_device_bytes, on_device_words, \
    want_kernels
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


def bytes_to_superframes(frame_bytes: torch.Tensor, cfg: SubchannelConfig):
    """[B, 5, frame_bytes] decoded frame bytes -> [B, superframe_bytes]."""
    return frame_bytes.reshape(frame_bytes.shape[0], cfg.superframe_bytes)


def decode_frames(flat: torch.Tensor, framebits: int, use_kernels: bool,
                  scan: bool = False, packed=False) -> torch.Tensor:
    """The chains' Viterbi stage: [N, 4*(framebits+6)] int32 symbols, or
    frame-major packed words int32[N, framebits+6] (``packed="bt"``) ->
    uint8[N, framebits//8]. With kernels, kernel A then kernel B; without,
    ``acs.forward`` and the blocked traceback (``scan``: the serial one,
    as the JAX package decodes punctured frames)."""
    nsteps = framebits + C.TAIL_BITS
    if use_kernels:
        return acs_cuda.decode(flat, framebits, packed=packed)
    if packed:
        flat = acs_cuda.unpack_symbols(flat, nsteps, packed)
    decisions, _ = acs.forward(flat, nsteps)
    if scan:
        return traceback.chainback_scan(decisions, framebits)
    return traceback.chainback_blocked(decisions, framebits,
                                       block=traceback.block_for(framebits))


def rs_superframes(sf: torch.Tensor, rs_dims: int,
                   use_kernels: bool | None = None):
    """The chains' RS stage: uint8[B, rs_dims*120] superframes ->
    (audio uint8[B, rs_dims*110], errors int32[B]). Every codeword is
    decoded and the audio keeps each as decoded, a failed one included
    (errors says -1): with kernels by one launch of kernel I
    (``rs_ops.rs_check_superframes``), without by its plain version.
    ``use_kernels=None`` takes the kernel for a superframe batch on a
    CUDA device."""
    check = (rs_ops.rs_check_superframes
             if want_kernels(use_kernels, sf.device)
             else rs_ops.rs_check_superframes_plain)
    errors, audio, _ = check(sf, rs_dims, zero_after_fail=False)
    return audio, errors


def protection_profile(protection, bitrate_kbps: int) -> P.Profile:
    """The ``puncture.Profile`` of a chain's ``protection``: an EEP
    ``(profile, level)`` such as ``("A", 3)`` at ``bitrate_kbps``, or a
    ``Profile`` itself, which must cover the bitrate's frame."""
    if isinstance(protection, P.Profile):
        prof = protection
    else:
        profile, level = protection
        prof = P.eep_profile(bitrate_kbps, int(level), profile)
    if prof.data_bits != 24 * bitrate_kbps:
        raise ValueError(f"{prof.name} covers {prof.data_bits} data bits, "
                         f"a frame at {bitrate_kbps} kbit/s has "
                         f"{24 * bitrate_kbps}")
    return prof


def depuncture_words(rec: torch.Tensor, prof: P.Profile,
                     kernels: bool) -> torch.Tensor:
    """The chains' depuncture stage, the span ``depuncture``: [N, kept]
    punctured symbols (uint8 or int32) -> int32[N, framebits+6]
    frame-major packed words (``packed="bt"``), by kernel J or its plain
    version. Counters: ``kept_bytes`` read, ``mother_bytes`` written,
    ``launches``."""
    with counts.stage("depuncture") as sp:
        fn = depuncture_ops.depuncture if kernels \
            else depuncture_ops.depuncture_plain
        mother = fn(rec, prof)
        if sp:
            sp.count(kept_bytes=rec.numel() * rec.element_size(),
                     mother_bytes=mother.numel())
    return mother.view(torch.int32)


def decode_audio_superframes(symbols, bitrate_kbps: int,
                             use_kernels: bool | None = None, device=None,
                             protection=None):
    """Decode a batch of DAB+ audio superframes end to end on the device.

    ``symbols``: int[B, 5, 4*(framebits+6)] soft symbols for 5 consecutive
    logical frames of one subchannel (already depunctured, as the
    reference expects), a tensor or a host array. With ``protection``
    (an EEP ``(profile, level)`` or a ``puncture.Profile``, see
    ``protection_profile``): int[B, 5, profile.transmitted_bits], the
    subchannel's punctured symbols as the MSC carries them (the low byte
    of each significant), depunctured on the device.

    Returns (audio uint8[B, rs_dims*110], rs_errors int32[B]) on the
    symbols' device: corrected audio superframe bytes and per-superframe
    corrected-byte counts (-1 = uncorrectable, matching
    RScheckSuperframe). The call is the span ``chain`` of
    ``runtime.calllog``, with its stages ``ingest``, ``depuncture`` (with
    ``protection``), ``viterbi`` and ``rs``; the caller reads the results
    back.
    """
    with calllog.span("chain"):
        cfg = SubchannelConfig(bitrate_kbps)
        if protection is None:
            syms, layout = on_device_words(symbols, device)
            B = syms.shape[0]
            kernels = want_kernels(use_kernels, syms.device)
        else:
            prof = protection_profile(protection, bitrate_kbps)
            rec = on_device_bytes(symbols, device)
            kept = prof.transmitted_bits
            if rec.dim() != 3 or rec.shape[1:] != (SUPERFRAME_FRAMES, kept):
                raise ValueError(f"symbols must be [B, {SUPERFRAME_FRAMES}, "
                                 f"{kept}] for {prof.name}, got "
                                 f"{list(rec.shape)}")
            B = rec.shape[0]
            kernels = want_kernels(use_kernels, rec.device)
            syms = depuncture_words(rec.reshape(-1, kept), prof, kernels)
            layout = "bt"
        flat = syms.reshape(B * SUPERFRAME_FRAMES, -1)
        with counts.stage("viterbi"):
            frame_bytes = decode_frames(flat, cfg.framebits, kernels,
                                        packed=layout)
        sf = bytes_to_superframes(
            frame_bytes.reshape(B, SUPERFRAME_FRAMES, cfg.frame_bytes), cfg)
        with counts.stage("rs"):
            out = rs_superframes(sf, cfg.rs_dims, kernels)
    return out


def decode_ensemble_sharded(symbols, bitrate_kbps: int,
                            mesh: mesh_mod.Mesh | None = None,
                            use_kernels: bool | None = None):
    """The full DAB+ audio chain data-parallel over the mesh's data axis:
    a batch of subchannel superframes -> Viterbi -> superframe assembly ->
    RS -> audio bytes and error counts (the QIRX composition the DLL
    serves, rschecksf.cpp:58-93, spread over ranks instead of host
    threads).

    ``symbols``: int[B, 5, 4*(framebits+6)], the whole batch on every rank
    (a tensor or a host array; only this rank's rows go to its device),
    ``B`` divisible by the data-axis size. Each rank runs
    ``decode_audio_superframes`` on its rows (on a card: kernels A and B,
    then kernel I) on the mesh's device. ``mesh=None`` takes the
    job's node mesh. Returns (audio uint8[B, rs_dims*110], errors
    int32[B]) on every rank.
    """
    if mesh is None:
        mesh = distributed.make_node_mesh()
    audio, errors = decode_audio_superframes(
        mesh_mod.local_rows(symbols, mesh), bitrate_kbps, use_kernels,
        mesh.device)
    group = mesh.groups[mesh_mod.DATA_AXIS]
    return (mesh_mod.all_gather_rows(group, audio),
            mesh_mod.all_gather_rows(group, errors))


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


def _decode_punctured(received, prof: P.Profile, use_kernels, device):
    """The punctured-frame decoders: [B, kept] symbols in, through the
    byte ingest and the depuncture stage, to the Viterbi stage (the
    serial traceback on the plain path, as the JAX package decodes
    punctured frames)."""
    rec = on_device_bytes(received, device)
    kernels = want_kernels(use_kernels, rec.device)
    return decode_frames(depuncture_words(rec, prof, kernels),
                         prof.data_bits, kernels, scan=True, packed="bt")


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
    return _decode_punctured(received, prof, use_kernels, device)


def decode_profile_frames(received, profile: P.Profile,
                          use_kernels: bool | None = None,
                          device=None) -> torch.Tensor:
    """Decode punctured frames of ANY ``puncture.Profile``, user-supplied
    UEP rows included (``puncture.uep_profile_from_row``).

    ``received``: int[B, profile.transmitted_bits] soft symbols. Returns
    uint8[B, profile.data_bits // 8] on the symbols' device.
    """
    return _decode_punctured(received, profile, use_kernels, device)
