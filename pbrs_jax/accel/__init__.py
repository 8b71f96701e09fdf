from . import dispatch  # noqa: F401
