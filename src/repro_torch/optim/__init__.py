from . import adamw, compression, schedule  # noqa: F401
