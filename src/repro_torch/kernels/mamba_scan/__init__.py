from . import mamba_scan, ops, ref  # noqa: F401
