"""Entry points, the twins of ``__graft_entry__.py``.

``entry(device=None)``            a single-card decode step on the main
                                  path (kernels A and B) and its example
                                  arguments;
``dryrun_multichip(n, device=None)`` one step of the whole several-rank
                                  pipeline on ``n`` ranks: data-parallel
                                  frames, rings of 2, 4, 8 blocks with
                                  their boundary exchanges on noisy
                                  frames, RS, the DAB+ ensemble chain.

Both run on the card unless the caller passes ``device="cpu"``, and raise
without a card otherwise. ``dryrun_multichip`` spawns its ranks
(``parallel.distributed.run_ranks``, gloo); on one card every rank runs on
``cuda:0``, and every path of every rank must launch kernels A and B
there. ``dryrun_rank`` is one rank's body, a module-level function so
that ranks of threads can run it too.
"""

from __future__ import annotations

import numpy as np
import torch

from . import api
from . import constants as C
from . import golden
from .harness import channel
from .ops import acs, acs_cuda, counts
from .ops import traceback as tb
from .runtime.placement import strict_device

FRAMEBITS = 3072     # entry(): the 128 kbit/s operating point
BATCH = 16
DP_FRAMEBITS = 48    # dryrun: the data-parallel frames
RING_BLOCK_BITS = 768
RING_DEPTHS = (2, 4, 8)
ENSEMBLE_KBPS = 32
RANK_TIMEOUT_S = 600.0


def entry(device=None):
    """Return ``(fn, (syms,))``: a batched decode of 16 DAB frames at 3072
    bits and its example symbols, those of ``__graft_entry__.entry``. On a
    card ``fn`` is ``acs_cuda.decode`` (kernels A and B); with
    ``device="cpu"`` it is the plain path the JAX version takes off the
    TPU, ``acs.forward`` then the blocked traceback (block 64)."""
    dev = strict_device(device)
    rng = np.random.default_rng(0)
    syms = torch.from_numpy(rng.integers(
        0, 256, (BATCH, C.RATE * (FRAMEBITS + C.TAIL_BITS)),
        dtype=np.int32)).to(dev)
    if dev.type == "cuda":
        def fn(symbols):
            return acs_cuda.decode(symbols, FRAMEBITS)
    else:
        def fn(symbols):
            decisions, _ = acs.forward(symbols, FRAMEBITS + C.TAIL_BITS)
            return tb.chainback_blocked(decisions, FRAMEBITS, block=64)
    return fn, (syms,)


def ring_depths(n: int) -> list:
    return [d for d in RING_DEPTHS if d <= n]


def dryrun_inputs(n: int) -> dict:
    """Every input of an ``n``-rank dryrun, drawn as
    ``__graft_entry__.dryrun_multichip`` draws them: host arrays."""
    rng = np.random.default_rng(0)
    B = 2 * n
    bits = rng.integers(0, 2, (B, DP_FRAMEBITS), dtype=np.uint8)
    dp = np.stack([golden.hard_to_soft(golden.encode(b)) for b in bits]) \
        .astype(np.int32)
    rings = {}
    for n_seq in ring_depths(n):
        n_data = n // n_seq
        _, syms = channel.make_frames(max(n_data, 2), RING_BLOCK_BITS * n_seq,
                                      seed=n_seq)
        rings[n_seq] = syms.astype(np.int32)
    msgs = rng.integers(0, 256, (4, C.RS_KK), dtype=np.uint8)
    cws = np.stack([golden.rs_encode_codeword(m) for m in msgs])
    from .models import dab
    cfg = dab.SubchannelConfig(ENSEMBLE_KBPS)
    audio = rng.integers(0, 256, (n, cfg.rs_dims, C.RS_KK), dtype=np.uint8)
    sf = []
    for sf_audio in audio:
        cws_sf = np.stack([golden.rs_encode_codeword(m) for m in sf_audio])
        frames = np.unpackbits(cws_sf.T.reshape(-1).astype(np.uint8)) \
            .reshape(dab.SUPERFRAME_FRAMES, cfg.framebits)
        sf.append(np.stack([golden.hard_to_soft(golden.encode(f))
                            for f in frames]))
    return {"dp_bits": bits, "dp_syms": dp, "rings": rings,
            "rs_codewords": cws.astype(np.int32), "ens_audio": audio,
            "ens_syms": np.stack(sf).astype(np.int32)}


def dryrun_rank(rank: int, world_size: int, store, device: str) -> dict:
    """One rank of ``dryrun_multichip``: every path it takes part in,
    checked where it runs (a mismatch raises). Returns its outputs as
    numpy and, for each path, its launches of kernels A-D."""
    import torch.distributed as dist

    from .models import dab
    from .ops import rs
    from .parallel import batch, mesh, streaming

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    api.initialize(device=dev)
    n = world_size
    inp = dryrun_inputs(n)
    res = {"rings": {}, "launches": {}}

    def grid(name, n_data, n_seq):
        if rank >= n_data * n_seq:
            return None
        return mesh.make_mesh(n_data, n_seq, rank=rank,
                              world_size=n_data * n_seq,
                              store=dist.PrefixStore(name, store),
                              device=dev)

    def path(name, fn):
        counts.zero_launches()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        n_launched = counts.launches()
        if dev.type == "cuda":
            lost = counts.missing(n_launched, ("acs_regs", "tb_walk"))
            if lost:
                raise AssertionError(f"rank {rank}: {name} never launched "
                                     f"{lost}: {n_launched}")
        res["launches"][name] = n_launched
        return out

    # data-parallel frames
    m = grid("dp", n, 1)
    out = path("dp", lambda: batch.decode_sharded(
        inp["dp_syms"], DP_FRAMEBITS, m, block=8)).cpu().numpy()
    if not np.array_equal(out, np.packbits(inp["dp_bits"], axis=1)):
        raise AssertionError(f"rank {rank}: DP decode wrong")
    res["dp"] = out
    # rings of every depth the ranks allow, noisy 768-bit blocks
    for n_seq, syms in inp["rings"].items():
        m = grid(f"ring{n_seq}", n // n_seq, n_seq)
        if m is None:
            continue
        stream_bits = RING_BLOCK_BITS * n_seq
        got = path(f"ring {n_seq}", lambda: streaming.decode_stream(
            syms, stream_bits, m)).cpu().numpy()
        # every rank of the ring holds the whole output: each holds it
        # against the golden whole-stream decode, independent of the
        # kernels the ring runs
        if not np.array_equal(got, golden.deconvolve_many(stream_bits,
                                                          syms)):
            raise AssertionError(f"rank {rank}: ring of {n_seq} != the "
                                 f"golden whole-stream decode")
        res["rings"][n_seq] = got
    # RS on clean codewords
    count, corrected = rs.rs_decode_blocks(
        torch.from_numpy(inp["rs_codewords"]).to(dev))
    if int(count.sum()) != 0:
        raise AssertionError(f"rank {rank}: RS dryrun wrong")
    res["rs"] = (count.cpu().numpy(), corrected.cpu().numpy())
    # the DAB+ ensemble chain, one superframe a rank
    m = grid("ensemble", n, 1)
    audio, errors = path("ensemble", lambda: dab.decode_ensemble_sharded(
        inp["ens_syms"], ENSEMBLE_KBPS, m))
    audio, errors = audio.cpu().numpy(), errors.cpu().numpy()
    cfg = dab.SubchannelConfig(ENSEMBLE_KBPS)
    got = audio.reshape(n, C.RS_KK, cfg.rs_dims).transpose(0, 2, 1)
    if errors.tolist() != [0] * n or not np.array_equal(got,
                                                        inp["ens_audio"]):
        raise AssertionError(f"rank {rank}: ensemble chain wrong")
    res["ensemble"] = (audio, errors)
    return res


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Run one step of the whole several-rank pipeline on ``n_devices``
    spawned ranks over gloo (on one card all on ``cuda:0``; with
    ``device="cpu"`` on the CPU). Raises on any mismatch, and on a card if
    a rank's path never launched kernels A and B. Returns each rank's
    outputs and launches (``dryrun_rank``)."""
    from .ops import _build
    from .parallel import distributed

    dev = strict_device(device)
    if dev.type == "cuda":
        _build.build()       # once, before the ranks load it
    ranks = distributed.run_ranks(dryrun_rank, n_devices, (str(dev),),
                                  timeout=RANK_TIMEOUT_S)
    for r in ranks[1:]:
        for key in ("dp", "rings"):
            same = (np.array_equal(r[key], ranks[0][key]) if key == "dp"
                    else all(np.array_equal(v, ranks[0][key].get(k))
                             for k, v in r[key].items()))
            if not same:
                raise AssertionError(f"the ranks' {key} outputs differ")
    depths = ring_depths(n_devices)
    form = "kernels A and B" if dev.type == "cuda" else "the plain form"
    print(f"dryrun_multichip OK: DP {n_devices}-way B={2 * n_devices}; SP "
          f"rings {depths} x {RING_BLOCK_BITS}-bit blocks, noisy 3 dB "
          f"frames ({form} at every depth); DAB+ ensemble chain "
          f"{n_devices}-way")
    return ranks
