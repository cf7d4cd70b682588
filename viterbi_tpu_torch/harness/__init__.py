from . import channel  # noqa: F401
