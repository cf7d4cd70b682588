"""One-card block-overlap streaming, recorded: the twin of
``scripts/stream_bench.py`` (``STREAM_TPU.json``). Writes
``STREAM_GPU.json``.

``parallel.streaming.make_local_stream_decoder`` (the blocks folded into
the batch: on a card two launches of kernel A and one of kernel B a call)
on noisy 3 dB streams made on the device:

  * parity: at 9216, 73 728 and 294 912 bits (1 to 32 times
    ``MAX_FRAMEBITS``) in 3072-bit blocks, 4 streams, bit-equal to the
    whole-stream decode through kernels A and B and to the plain form;
  * throughput: device ms of a call and Gsym/s at (9216 bits, 2048
    streams), (73 728, 256) and (294 912, 64), beside kernels A and B on
    the same number of whole 3072-bit frames, with the measured overhead
    against the predicted (overlap + warm-up) / block of the kernel
    form's own layout; and the device ms of the call's parts, each alone.

``cell`` is one such measurement; ``chip_smoke.py`` phase 14 calls it at
its own shapes.

Usage: python -m viterbi_tpu_torch.tools.stream [--device cpu]
       [--out PATH]
"""

from __future__ import annotations

import sys

import torch

from .. import constants as C
from ..harness import channel
from ..runtime.placement import strict_device
from . import _record

BLOCK = 3072
PARITY = (9216, 73728, 294912)               # stream bits, 4 streams each
PARITY_STREAMS = 4
THROUGHPUT = ((9216, 2048), (73728, 256), (294912, 64))
WHOLE_ROWS = 4       # streams held against the whole-stream decode
ITERS = 5


def cell(dev, streams: int, n_blocks: int, blk: int, seed: int,
         hold=None, iters: int = ITERS) -> dict:
    """``streams`` noisy terminated streams of ``n_blocks`` blocks of
    ``blk`` bits through ``make_local_stream_decoder`` on ``dev``: its
    launches, its output against the plain form and, on the first
    ``WHOLE_ROWS`` streams, the whole-stream decode through kernels A and
    B; bit errors; device ms of the call and (where the kernels ran) of
    its parts, each alone. ``hold(fwd, walk)``, if given, gets the call's
    recorded ``forward_regs`` and ``chainback_regs_cuda_anchored`` calls
    while their tensors live."""
    from ..ops import acs_cuda
    from ..ops import traceback as tb
    from ..parallel import streaming
    sb = n_blocks * blk
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(0, 2, (streams, sb), generator=gen, device=dev)
    syms = channel.soft_on_device(bits, False, gen)
    data, tail = syms[:, :C.RATE * sb], syms[:, C.RATE * sb:]
    dec = streaming.make_local_stream_decoder(sb, n_blocks, device=dev)
    _record.zero_launches()
    with _record.recorded(acs_cuda, "forward_regs") as fwd, \
            _record.recorded(tb, "chainback_regs_cuda_anchored") as walk:
        out = dec(data, tail)
    _record.sync(dev)
    launches = _record.launches()
    plain = streaming.make_local_stream_decoder(
        sb, n_blocks, use_kernels=False, device=dev)(data, tail)
    whole = acs_cuda.decode(syms[:WHOLE_ROWS], sb)
    rec = dict(streams=streams, n_blocks=n_blocks, block_bits=blk,
               stream_bits=sb, launches=launches,
               equal_plain=bool(torch.equal(out, plain)),
               equal_whole=bool(torch.equal(out[:WHOLE_ROWS], whole)),
               bit_errors=channel.bit_errors_on_device(out, bits))
    del plain, whole
    kernels = dev.type == "cuda"
    rec["layout"] = dict(zip(("overlap", "warmup", "ckpt"),
                             streaming._plan_block_layout(blk, None, None,
                                                          kernels)))
    if kernels:
        rec["launches_ok"] = _record.only({"acs_regs": 2, "tb_walk": 1},
                                          launches)
        if hold is not None:
            hold(fwd, walk)
        (wa, wkw, _), (fa, fkw, _) = fwd
        wargs = walk[0][0]
        rec["parts_ms"] = {
            "packing": _record.device_ms(
                lambda: acs_cuda.pack_symbols(data, sb), dev, iters),
            "A warm-up": _record.device_ms(
                lambda: acs_cuda.forward_regs(*wa, **wkw), dev, iters),
            "A full pass": _record.device_ms(
                lambda: acs_cuda.forward_regs(*fa, **fkw), dev, iters),
            "B": _record.device_ms(
                lambda: tb.chainback_regs_cuda_anchored(*wargs), dev,
                iters)}
        del fwd, walk, wa, fa, wargs
    rec["ms"] = _record.device_ms(lambda: dec(data, tail), dev, iters)
    rec["gsym_s"] = streams * C.RATE * (sb + C.TAIL_BITS) / rec["ms"] / 1e6
    rec["ok"] = rec["equal_plain"] and rec["equal_whole"] and \
        rec.get("launches_ok", True)
    return rec


def fused_ms(dev, frames: int, blk: int, iters: int = ITERS) -> float:
    """Device ms of kernels A and B (``acs_cuda.decode``) on ``frames``
    whole frames of ``blk`` bits, resident packed words."""
    from ..ops import acs_cuda
    gen = torch.Generator(device=dev).manual_seed(frames)
    words = torch.randint(-2**31, 2**31, (frames, blk + C.TAIL_BITS),
                          generator=gen, dtype=torch.int32, device=dev)
    return _record.device_ms(
        lambda: acs_cuda.decode(words, blk, packed="bt"), dev, iters)


def run(device=None, parity=PARITY, throughput=THROUGHPUT,
        blk: int = BLOCK, parity_streams: int = PARITY_STREAMS) -> dict:
    dev = strict_device(device)
    doc = {"device": _record.stamp(dev), "block_bits": blk, "parity": {},
           "throughput": {}}
    for sb in parity:
        rec = cell(dev, parity_streams, sb // blk, blk, seed=sb)
        doc["parity"][str(sb)] = rec
        print(f"parity {sb} bits ({sb // blk} blocks): ok {rec['ok']}",
              flush=True)
    for sb, streams in throughput:
        rec = cell(dev, streams, sb // blk, blk, seed=streams + sb)
        frames = streams * sb // blk
        f_ms = fused_ms(dev, frames, blk)
        f_rate = frames * C.RATE * (blk + C.TAIL_BITS) / f_ms / 1e6
        overlap, warm = rec["layout"]["overlap"], rec["layout"]["warmup"]
        rec.update(fused_wholeframe_ms=f_ms, fused_wholeframe_gsym_s=f_rate,
                   ratio_vs_fused=rec["gsym_s"] / f_rate,
                   predicted_overhead=(overlap + warm) / blk)
        rec["measured_overhead"] = 1 - rec["ratio_vs_fused"]
        doc["throughput"][str(sb)] = rec
        print(f"stream {sb} bits x {streams}: {rec['gsym_s']:.2f} Gsym/s, "
              f"kernels A and B on {frames} whole frames {f_rate:.2f}",
              flush=True)
    doc["ok"] = all(r["ok"] for part in ("parity", "throughput")
                    for r in doc[part].values())
    return doc


def main(argv=None) -> int:
    args = _record.parser(__doc__).parse_args(argv)
    return _record.finish(run(args.device), args.out, "STREAM")


if __name__ == "__main__":
    sys.exit(main())
