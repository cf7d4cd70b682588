"""Host-side helpers: the native host library (``native``) and the
pipelined host-to-device feed (``pipeline``)."""

from . import native    # noqa: F401
from . import pipeline  # noqa: F401
