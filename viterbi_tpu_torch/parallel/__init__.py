"""Decoding beyond one frame on one card: block-overlap streaming of a
stream much longer than ``MAX_FRAMEBITS`` (``streaming``) and sessions
that decode a stream arriving in chunks (``session``). The port of the
one-card parts of ``viterbi_tpu.parallel``; the sharded decoders wait
for ``torch.distributed``."""

from . import streaming  # noqa: F401
from . import session    # noqa: F401
from .session import StreamSession  # noqa: F401
