"""On-card parity record, the twin of ``scripts/tpu_parity.py``
(``PARITY_TPU.json``): every rung and every kernel form, on the card,
against the golden model, in the same twelve sections. Writes
``PARITY_GPU.json``.

Sections: ``viterbi`` (the four rungs x 8 ... 384 kbit/s on noisy 3 dB
frames, each against golden and against each other; the TPU package's
``pallas_fused_x6`` is kernel A itself), ``layout_classes`` (kernels A and
C with one lane and four lanes a frame, kernel B at 1 to 32 segments a
frame, at the JAX cells' frame sizes: each against its plain version and
the decode against golden), ``torch_scan_small_frames`` (first call at a
fresh size against a warm one), ``rs`` (superframes and fuzz codewords),
``tailbiting``, ``punctured`` (with the T-DMB chain), ``packed_bt``, ``large_batch_blocked`` (C +
D and C + the blocked walk at B 512-1024), ``superframe_chain``,
``streaming_1chip``, ``arbitrary_framebits`` (off the byte grid, through
the API) and ``sharded_ensemble_chain`` (over two spawned ranks). On a
card kernels A, B, C and D must each launch.

Usage: python -m viterbi_tpu_torch.tools.parity [--quick] [--device cpu]
       [--out PATH]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import api
from .. import constants as C
from .. import golden
from ..harness import channel
from ..runtime.placement import strict_device
from . import _record

RUNGS = ("torch_scan", "torch_blocked", "cuda_words", "cuda_fused")
BITRATES = (8, 32, 64, 96, 128, 192, 384)
LAYOUT_FRAMEBITS = (8, 64, 96, 168, 224, 744)
LARGE = ((3072, 1024), (9216, 512))     # (framebits, batch)
SEGMENTS = (1, 2, 4, 8, 16, 32)
LANES = (1, 4)
SF_KBPS = 96
ARBITRARY = (1, 7, 9, 50, 100, 9215)
STREAM_BITS = 6144
ENSEMBLE_RANKS = 2
RANK_TIMEOUT_S = 600.0


def _bad_frames(out, expect) -> int:
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
    return int((np.asarray(out) != expect).any(axis=1).sum())


def viterbi(dev, quick: bool, bitrates=BITRATES) -> dict:
    cells, bad, total = [], 0, 0
    for kbps in bitrates:
        fb = 24 * kbps
        n = 8 if quick else 64 if fb <= 3072 else 16
        _, syms = channel.make_frames(n, fb, seed=kbps)
        expect = golden.deconvolve_many(fb, syms)
        x = torch.from_numpy(syms.astype(np.int32)).to(dev)
        outs = []
        for rung in RUNGS:
            t0 = time.perf_counter()
            out = api._decode_tensor(x, fb, rung).cpu().numpy()
            cell_bad = _bad_frames(out, expect)
            bad += cell_bad
            total += n
            outs.append(out)
            cells.append(dict(rung=rung, kbps=kbps, framebits=fb, frames=n,
                              mismatch_frames=cell_bad,
                              secs=time.perf_counter() - t0))
        # cross-rung equality on identical noise
        bad += sum(int(not np.array_equal(outs[0], o)) for o in outs[1:])
    return dict(cells=cells, frames=total, mismatch_frames=bad,
                note="each rung against golden and the others on identical "
                     "3 dB noise; cuda_fused is kernels A and B, the TPU "
                     "package's pallas_fused and pallas_fused_x6 alike")


def layout_classes(dev, quick: bool, framebits=LAYOUT_FRAMEBITS) -> dict:
    """Kernels A and C in both forms and kernel B in every form at the
    JAX cells' sizes (non-CG, front-pad and odd natural-ckpt classes
    there): each against its plain version, the decode against golden."""
    from ..ops import acs_cuda
    from ..ops import traceback as tb
    rng = np.random.default_rng(55)
    cells, bad = [], 0
    for fb in framebits:
        n = 8 if quick else 32
        nsteps = fb + C.TAIL_BITS
        syms = rng.integers(0, 256, (n, C.RATE * nsteps)).astype(np.int32)
        expect = golden.deconvolve_many(fb, syms)
        x = torch.from_numpy(syms).to(dev)
        ckpt = acs_cuda.DECODE_CKPT
        regs_p, met_p = acs_cuda.forward_regs_plain(x, nsteps, ckpt=ckpt)
        dec_p, dmet_p = acs_cuda.forward_plain(x, nsteps)
        gap = nsteps - (regs_p.shape[0] - 1) * ckpt
        rs_p = tb.tb_walk_plain(regs_p, ckpt, gap)
        cell = dict(framebits=fb, frames=n, ckpt=ckpt, mismatch_kernel=0,
                    mismatch_frames=0)
        for lanes in LANES:
            regs, met = acs_cuda.forward_regs(x, nsteps, ckpt=ckpt,
                                              lanes=lanes)
            dec, dmet = acs_cuda.forward(x, nsteps, lanes=lanes)
            cell["mismatch_kernel"] += sum(
                int(not torch.equal(a.cpu(), b.cpu()))
                for a, b in ((regs, regs_p), (met, met_p), (dec, dec_p),
                             (dmet, dmet_p)))
            cell["mismatch_frames"] += _bad_frames(
                tb.chainback_blocked(dec, fb, block=8), expect)
        for segments in SEGMENTS:
            rs = tb.tb_walk(regs_p, ckpt, gap, segments=segments)
            cell["mismatch_kernel"] += int(not torch.equal(rs.cpu(),
                                                           rs_p.cpu()))
            cell["mismatch_frames"] += _bad_frames(
                tb._regs_bits(rs, fb, ckpt, gap), expect)
        bad += cell["mismatch_kernel"] + cell["mismatch_frames"]
        cells.append(cell)
    return dict(cells=cells, lanes=list(LANES), segments=list(SEGMENTS),
                mismatch_frames=bad,
                note="kernels A and C with one lane and four lanes a frame, "
                     "kernel B at 1 to 32 segments a frame, each against "
                     "its plain version and the decode against golden")


def torch_scan_small_frames(dev, quick: bool) -> dict:
    """The torch_scan rung's first call at a size not run before (384
    bits) against a warm one (192 bits, run in ``viterbi``)."""
    n = 8 if quick else 64
    _, syms16 = channel.make_frames(n, 384, seed=161)
    x16 = torch.from_numpy(syms16.astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    out16 = api._decode_tensor(x16, 384, "torch_scan").cpu()
    fresh = time.perf_counter() - t0
    _, syms8 = channel.make_frames(n, 192, seed=8)
    x8 = torch.from_numpy(syms8.astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    api._decode_tensor(x8, 192, "torch_scan").cpu()
    warm = time.perf_counter() - t0
    return dict(fresh_shape_s=fresh, warm_same_shape_s=warm,
                mismatch_frames=_bad_frames(
                    out16, golden.deconvolve_many(384, syms16)),
                note="eager torch compiles nothing: the first call at a "
                     "new size costs what a warm one does")


def rs(dev, quick: bool) -> dict:
    from ..ops import rs as rs_ops
    rng = np.random.default_rng(1234)
    sf_bad, n_sf, rs_dims = 0, 2 if quick else 8, 16
    for sfi in range(n_sf):
        msgs = rng.integers(0, 256, (rs_dims, C.RS_KK), dtype=np.uint8)
        cws = np.stack([golden.rs_encode_codeword(m)
                        for m in msgs]).astype(np.int64)
        errs = rng.integers(0, 10, rs_dims)     # 0..9 errors (> 5 fails)
        if sfi % 2 == 0:
            errs = np.minimum(errs, 5)          # half the superframes clean
        for i, e in enumerate(errs):
            if e:
                pos = rng.choice(C.RS_N, e, replace=False)
                cws[i, pos] ^= rng.integers(1, 256, e)
        inter = cws.T.reshape(-1).astype(np.uint8)
        g_err, g_out = golden.rs_check_superframe(inter, rs_dims)
        errors, out, _ = rs_ops.rs_check_superframe(
            torch.from_numpy(inter).to(dev), rs_dims)
        sf_bad += int(int(errors) != g_err
                      or not np.array_equal(out.cpu().numpy(), g_out))
    fuzz = rng.integers(0, 256, (64, C.RS_N)).astype(np.int64)
    count, corrected = rs_ops.rs_decode_blocks(
        torch.from_numpy(fuzz.astype(np.int32)).to(dev))
    count, corrected = count.cpu().numpy(), corrected.cpu().numpy()
    fuzz_bad = 0
    for i in range(len(fuzz)):
        g_c, g_d = golden.rs_decode_codeword(fuzz[i])
        fuzz_bad += int(count[i] != g_c
                        or not np.array_equal(corrected[i], g_d))
    return dict(superframes=n_sf, rs_dims=rs_dims,
                mismatch_superframes=sf_bad, fuzz_codewords=len(fuzz),
                mismatch_fuzz=fuzz_bad)


def tailbiting(dev, quick: bool) -> dict:
    from ..ops import tailbiting as tb_ops
    rng = np.random.default_rng(1235)
    fb, n = 768, 4 if quick else 16
    bits = rng.integers(0, 2, (n, fb), dtype=np.uint8)
    syms = np.stack([golden.hard_to_soft(golden.encode_tailbiting(b))
                     for b in bits]).astype(np.int32)
    expect = np.stack([golden.tailbiting_decode(fb, s, wrap_steps=96)
                       for s in syms])
    out = tb_ops.decode_tailbiting(torch.from_numpy(syms).to(dev), fb,
                                   wrap_steps=96)
    return dict(frames=n, framebits=fb,
                mismatch_frames=_bad_frames(out, expect))


def punctured(dev, quick: bool) -> dict:
    from ..models import dab
    from ..models import puncture as P
    kbps, level, prof = 128, 3, "A"
    fb, n = 24 * kbps, 4 if quick else 16
    _, mother = channel.make_frames(n, fb, seed=77)
    mask = P.frame_mask(kbps, level, prof)
    received = np.stack([P.puncture(m, mask) for m in mother])
    expect = golden.deconvolve_many(fb, P.depuncture(received, mask))
    out = dab.decode_punctured_frames(
        torch.from_numpy(received.astype(np.int32)).to(dev), kbps, level,
        prof)
    return dict(frames=n, profile=f"EEP-{prof} level {level} {kbps}kbps",
                mismatch_frames=_bad_frames(out, expect),
                **ts_streams(dev, quick))


def ts_streams(dev, quick: bool) -> dict:
    """The T-DMB chain (kernels J, A, B, K and kernel I's RS(204,188)
    entry on a card) on two transport streams at 136 kbit/s EEP-3A over
    14 CIFs (28 in the full run), past the eleven packets of zero fill so
    that RS meets corrected and uncorrectable packets, fresh and then
    continued with the state, against the plain reference
    (``reference.tdmb``): the packets, counts and state that differ."""
    from ..models import tdmb
    from ..reference import tdmb as ref_tdmb
    kbps, cifs = 136, 14 if quick else 28
    rx = channel.make_ts_streams(2, cifs, kbps, seed=78, bad=(1,))
    want = ref_tdmb.decode_ts_streams(rx, kbps)
    x = torch.from_numpy(rx).to(dev)
    first = tdmb.decode_ts_streams(x[:, :cifs // 2], kbps)
    last = tdmb.decode_ts_streams(x[:, cifs // 2:], kbps, state=first[2])
    got = (torch.cat([first[0], last[0]], 1), torch.cat([first[1], last[1]],
                                                        1), last[2])
    return dict(ts_streams=2, ts_cifs=cifs,
                ts_corrected=int((want[1] > 0).sum()),
                ts_failed=int((want[1] == -1).sum()), mismatch_ts=sum(
                    int(not torch.equal(g.cpu(), w))
                    for g, w in zip(got, want)))


def packed_bt(dev, quick: bool) -> dict:
    from ..ops import acs_cuda
    bad = frames = 0
    for kbps in (32, 128):
        fb, n = 24 * kbps, 8 if quick else 32
        _, syms = channel.make_frames(n, fb, seed=300 + kbps)
        expect = golden.deconvolve_many(fb, syms)
        words = torch.from_numpy(acs_cuda.pack_symbols_host(syms)).to(dev)
        bad += _bad_frames(acs_cuda.decode(words, fb, packed="bt"), expect)
        frames += n
    return dict(frames=frames, mismatch_frames=bad,
                note="host-packed one-word-a-step frame-major words (the "
                     "deconvolve_batch(packed=True) layout) through kernels "
                     "A and B, against golden")


def large_batch_blocked(dev, quick: bool, cells=LARGE) -> dict:
    """Kernel C at B 512-1024, walked by kernel D and by the blocked
    traceback; the first 4 frames against golden."""
    from ..ops import acs_cuda
    from ..ops import traceback as tb
    bad = 0
    for fb, B in cells:
        rng = np.random.default_rng(fb)
        syms = rng.integers(0, 256, (B, C.RATE * (fb + C.TAIL_BITS))) \
            .astype(np.int32)
        expect = golden.deconvolve_many(fb, syms[:4])
        dec, _ = acs_cuda.forward(torch.from_numpy(syms).to(dev),
                                  fb + C.TAIL_BITS)
        for out in (tb.chainback_words_cuda(dec, fb),
                    tb.chainback_blocked(dec, fb, block=64)):
            bad += int(not np.array_equal(out[:4].cpu().numpy(), expect))
    return dict(cells=[dict(framebits=f, batch=b) for f, b in cells],
                mismatch_cells=bad,
                note="kernel C's decisions at production batches, walked by "
                     "kernel D and by the blocked traceback")


def superframes(quick: bool, kbps: int = SF_KBPS):
    """The superframe chain's inputs and the golden composition: noisy 3
    dB frames of RS codewords with injected byte errors."""
    cfgB = 2 if quick else 8
    fb, rs_dims = 24 * kbps, kbps // 8
    rng = np.random.default_rng(400)
    audio_in = rng.integers(0, 256, (cfgB, rs_dims, C.RS_KK), dtype=np.uint8)
    sf_syms = np.empty((cfgB, 5, C.RATE * (fb + C.TAIL_BITS)), np.int32)
    g_audio = np.empty((cfgB, rs_dims * C.RS_KK), dtype=np.uint8)
    g_errors = np.empty(cfgB, dtype=np.int64)
    for b in range(cfgB):
        cws = np.stack([golden.rs_encode_codeword(m)
                        for m in audio_in[b]]).astype(np.int64)
        for i, e in enumerate(rng.integers(0, 5, rs_dims)):
            if e:
                pos = rng.choice(C.RS_N, e, replace=False)
                cws[i, pos] ^= rng.integers(1, 256, e)
        frame_bits = np.unpackbits(cws.T.reshape(-1).astype(np.uint8)) \
            .reshape(5, fb)
        for f in range(5):
            sf_syms[b, f] = channel.awgn_soft_symbols(
                golden.encode(frame_bits[f]), rng)
        dec = golden.deconvolve_many(fb, sf_syms[b]).reshape(-1)
        g_errors[b], g_audio[b] = golden.rs_check_superframe(dec, rs_dims)
    return sf_syms, g_audio, g_errors


def _chain_mismatches(audio, errors, g_audio, g_errors) -> int:
    audio, errors = np.asarray(audio), np.asarray(errors)
    return int((errors != g_errors).sum()) + sum(
        int(not np.array_equal(audio[b], g_audio[b]))
        for b in range(len(g_errors)) if g_errors[b] != -1)


def superframe_chain(dev, sf) -> dict:
    from ..models import dab
    sf_syms, g_audio, g_errors = sf
    audio, errors = dab.decode_audio_superframes(
        torch.from_numpy(sf_syms).to(dev), SF_KBPS)
    return dict(superframes=len(sf_syms), kbps=SF_KBPS,
                rs_dims=SF_KBPS // 8,
                mismatch_superframes=_chain_mismatches(
                    audio.cpu(), errors.cpu(), g_audio, g_errors),
                note="decode_audio_superframes (Viterbi, assembly, RS) "
                     "against the golden per-frame composition, noisy 3 dB "
                     "frames and injected RS byte errors")


def _ensemble_rank(rank, world_size, store, device, sf_syms):
    """One rank of ``sharded_ensemble_chain`` (a spawned process)."""
    from ..models import dab
    from ..parallel import mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    api.initialize(device=dev)
    m = mesh.make_mesh(world_size, 1, rank=rank, world_size=world_size,
                       store=store, device=dev)
    _record.zero_launches()
    audio, errors = dab.decode_ensemble_sharded(sf_syms, SF_KBPS, m)
    _record.sync(dev)
    return audio.cpu().numpy(), errors.cpu().numpy(), _record.launches()


def sharded_ensemble_chain(dev, sf, ranks: int = ENSEMBLE_RANKS) -> dict:
    from ..parallel import distributed
    sf_syms, g_audio, g_errors = sf
    res = distributed.run_ranks(_ensemble_rank, ranks, (str(dev), sf_syms),
                                timeout=RANK_TIMEOUT_S)
    bad = sum(_chain_mismatches(a, e, g_audio, g_errors) for a, e, _ in res)
    lost = [r for r, (_, _, n) in enumerate(res)
            if dev.type == "cuda" and _record.missing(n, ("acs_regs",
                                                          "tb_walk"))]
    return dict(superframes=len(sf_syms), kbps=SF_KBPS, ranks=ranks,
                launches_by_rank=[n for _, _, n in res],
                mismatch_superframes=bad, mismatch_ranks_without_kernels=len(
                    lost),
                note="decode_ensemble_sharded over spawned ranks on one "
                     "device (gloo), every rank's copy against the golden "
                     "composition")


def streaming_1chip(dev, quick: bool) -> dict:
    from ..parallel import streaming
    n = 4 if quick else 16
    _, syms = channel.make_frames(n, STREAM_BITS, seed=9)
    expect = golden.deconvolve_many(STREAM_BITS, syms)
    x = torch.from_numpy(syms.astype(np.int32)).to(dev)
    out = streaming.make_local_stream_decoder(STREAM_BITS, 1, device=dev)(
        x[:, :C.RATE * STREAM_BITS], x[:, C.RATE * STREAM_BITS:])
    return dict(frames=n, stream_bits=STREAM_BITS,
                mismatch_frames=_bad_frames(out, expect))


def arbitrary_framebits(quick: bool) -> dict:
    """Off the byte grid through the public API (the reference's
    partial-byte contract), against golden."""
    cells, bad = [], 0
    for fb in ARBITRARY:
        n = 2 if quick else 4
        _, syms = channel.make_frames(n, fb, seed=600 + fb)
        ret, out = api.deconvolve_batch(fb, syms)
        cell_bad = n if ret != 0 else _bad_frames(
            out, golden.deconvolve_many(fb, syms))
        bad += cell_bad
        cells.append(dict(framebits=fb, frames=n, mismatch_frames=cell_bad))
    return dict(cells=cells, mismatch_frames=bad)


def run(quick: bool = False, device=None, bitrates=BITRATES,
        large=LARGE) -> dict:
    """Every section; ``ok`` only if none has a mismatch and, on a card,
    every kernel of ``ops.counts`` launched (A-D, I's three entries, J
    and K)."""
    from ..runtime import dispatch
    dev = strict_device(device)
    api.initialize()
    api_dev = dispatch.ready().device
    if api_dev.type != dev.type:
        raise RuntimeError(f"the API decodes on {api_dev}, not on {dev}")
    doc = {"device": _record.stamp(dev), "quick": quick, "sections": {}}
    sf = superframes(quick)
    sections = (
        ("viterbi", lambda: viterbi(dev, quick, bitrates)),
        ("layout_classes", lambda: layout_classes(dev, quick)),
        ("torch_scan_small_frames",
         lambda: torch_scan_small_frames(dev, quick)),
        ("rs", lambda: rs(dev, quick)),
        ("tailbiting", lambda: tailbiting(dev, quick)),
        ("punctured", lambda: punctured(dev, quick)),
        ("packed_bt", lambda: packed_bt(dev, quick)),
        ("large_batch_blocked", lambda: large_batch_blocked(dev, quick,
                                                            large)),
        ("superframe_chain", lambda: superframe_chain(dev, sf)),
        ("streaming_1chip", lambda: streaming_1chip(dev, quick)),
        ("arbitrary_framebits", lambda: arbitrary_framebits(quick)),
        ("sharded_ensemble_chain",
         lambda: sharded_ensemble_chain(dev, sf)))
    _record.zero_launches()
    for name, section in sections:
        t0 = time.perf_counter()
        rec = doc["sections"][name] = section()
        rec["secs"] = time.perf_counter() - t0
        print(f"[{name}] " + ", ".join(
            f"{k} {v}" for k, v in rec.items()
            if k.startswith("mismatch") or k in ("frames", "secs")),
            flush=True)
    _record.sync(dev)
    doc["launches"] = _record.launches()
    doc["mismatches"] = sum(v for s in doc["sections"].values()
                            for k, v in s.items() if k.startswith("mismatch"))
    doc["kernels_not_launched"] = (
        _record.missing(doc["launches"], _record.KERNELS)
        if dev.type == "cuda" else [])
    doc["ok"] = doc["mismatches"] == 0 and not doc["kernels_not_launched"]
    return doc


def main(argv=None) -> int:
    ap = _record.parser(__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="fewer frames a cell (a smoke run)")
    args = ap.parse_args(argv)
    api.initialize(device=args.device)   # this process's API device
    return _record.finish(run(args.quick, args.device), args.out, "PARITY")


if __name__ == "__main__":
    sys.exit(main())
