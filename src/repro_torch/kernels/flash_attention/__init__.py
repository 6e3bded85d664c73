from . import flash_attention, ops, ref  # noqa: F401
