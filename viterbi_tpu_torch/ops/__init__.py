from . import acs         # noqa: F401
from . import acs_cuda    # noqa: F401
from . import traceback   # noqa: F401
