"""Decoding beyond one frame and beyond one process: the port of
``viterbi_tpu.parallel``.

On one card: block-overlap streaming of a stream much longer than
``MAX_FRAMEBITS``, its blocks folded into the batch
(``streaming.make_local_stream_decoder``), and sessions that decode a
stream arriving in chunks (``session``, ``StreamSession``).

Over several processes, each with its device (ranks may share a card):
``mesh`` lays a [data, seq] grid of ``torch.distributed`` process groups
over them, ``distributed`` joins a launched job (and starts the ranks of
a one-host job), ``batch.decode_sharded`` decodes frames data-parallel,
and ``streaming.make_stream_decoder`` / ``decode_stream`` run the blocks
of one stream on a ring of seq ranks that swap boundary metrics and
overlap symbols.
"""

from . import mesh         # noqa: F401
from . import distributed  # noqa: F401
from . import batch        # noqa: F401
from . import streaming    # noqa: F401
from . import session      # noqa: F401
from .session import StreamSession  # noqa: F401
