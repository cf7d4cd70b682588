"""Data-parallel sharded decode: the port of ``viterbi_tpu.parallel.batch``.

Independent frames over the mesh's data axis, the analog of QIRX's
thread-level parallelism over subchannels (SURVEY.md §2.7 row 2): each
rank decodes its rows of the frame batch with the rung the dispatcher
chose (on a card ``cuda_fused``: kernels A and B), and one all-gather
hands every rank the whole result. No communication in the hot loop.
"""

from __future__ import annotations

import torch

from .. import api
from ..runtime import dispatch
from ..runtime.placement import on_device
from . import distributed
from . import mesh as mesh_mod


def decode_sharded(symbols, framebits: int, mesh: mesh_mod.Mesh | None = None,
                   block: int | None = None) -> torch.Tensor:
    """Decode a [B, 4*(framebits+6)] batch sharded over the data axis.

    ``symbols``: the whole batch on every rank (a tensor or a host array;
    only this rank's rows go to its device). ``B`` must divide evenly by
    the data-axis size. ``block`` is the blocked traceback's block on the
    ``torch_blocked`` rung (None: the config key ``traceback_block``, as
    ``deconvolve_batch`` takes it). ``mesh=None`` takes the job's node mesh
    (``distributed.make_node_mesh``). Returns uint8[B, ceil(framebits/8)]
    on this rank's device, the same on every rank.
    """
    if mesh is None:
        mesh = distributed.make_node_mesh()
    st = dispatch.ready()
    rows = on_device(mesh_mod.local_rows(symbols, mesh), mesh.device)
    out = api._decode_tensor(rows, framebits, dispatch.VARIANTS[st.variant],
                             block=block)
    return mesh_mod.all_gather_rows(mesh.groups[mesh_mod.DATA_AXIS], out)
