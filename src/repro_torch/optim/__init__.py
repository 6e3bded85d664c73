from . import compression  # noqa: F401
