"""Model layers: plain functions on tensors over a params dict."""
from . import attention, common, mamba, moe  # noqa: F401
