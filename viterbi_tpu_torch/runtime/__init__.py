from . import config    # noqa: F401
from . import dispatch  # noqa: F401
from . import faults    # noqa: F401
from . import calllog   # noqa: F401
