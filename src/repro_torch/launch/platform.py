"""Per-backend platform configuration in one place.

The port's counterpart of the reference's XLA flag table.  Call
:func:`configure` (idempotent) before the first CUDA call: the CUDA
runtime reads its environment (``CUDA_MODULE_LOADING``) once, when it
initialises, so a value set later is ignored.

Imports no torch at module level.  The backend is chosen by env
(``REPRO_PLATFORM``) and defaults to ``cuda``: the port's entry points
run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

# env defaults per backend; a value the user already set wins
_ENV_DEFAULTS: Dict[str, Dict[str, str]] = {
    "cuda": {
        # load each kernel module at its first launch, not at start-up
        "CUDA_MODULE_LOADING": "LAZY",
    },
}

_configured: Optional[str] = None


def backend() -> str:
    """Target backend: REPRO_PLATFORM, else cuda."""
    return os.environ.get("REPRO_PLATFORM", "").strip().lower() or "cuda"


def _torch_settings(plat: str) -> None:
    """Float32 products stay full float32 on the card: TF32 off for
    matmul (PyTorch's default) and for cuDNN (on by default), as the
    reference's products and the kernels' tolerances assume."""
    if plat != "cuda":
        return
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def configure(plat: Optional[str] = None, *, force: bool = False) -> str:
    """Set the backend's env defaults and torch settings.  Idempotent: a
    second call for the same backend is a no-op."""
    global _configured
    plat = (plat or backend()).lower()
    if _configured == plat and not force:
        return plat
    for k, v in _ENV_DEFAULTS.get(plat, {}).items():
        os.environ.setdefault(k, v)
    _torch_settings(plat)
    _configured = plat
    return plat
