"""Public wrapper for the K-Means assignment kernel.

For a CUDA tensor :func:`assign` launches the hand-written kernel
(:mod:`.kmeans`) or raises — it never falls back.  For a CPU tensor it
runs the plain version (:mod:`.ref`), which is what the CPU tests reach.
``LAUNCHES`` counts kernel launches and nothing else, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import threading
from typing import Tuple

import torch

from . import kmeans as kernel
from . import ref

LAUNCHES = 0
_count_lock = threading.Lock()


def assign(points: torch.Tensor, centroids: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: points (n, d), centroids (k, d), f32
    or bf16 (upcast to f32) -> (idx (n,) int32, squared distance (n,) f32).
    The first index wins a tie."""
    if points.device.type == "cpu":
        return ref.assign(points, centroids)
    if points.device.type != "cuda":
        raise ValueError(f"assign: unsupported device {points.device}")
    if centroids.device != points.device:
        raise ValueError(f"assign: centroids on {centroids.device}, "
                         f"points on {points.device}")
    if points.ndim != 2 or centroids.ndim != 2 \
            or points.shape[1] != centroids.shape[1]:
        raise ValueError(f"assign: shapes {tuple(points.shape)} and "
                         f"{tuple(centroids.shape)} are not (n, d), (k, d)")
    for t in (points, centroids):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"assign: dtype {t.dtype} is not f32 or bf16")
        if not t.is_contiguous():
            raise ValueError("assign: inputs must be contiguous")
    n, d = points.shape
    k = centroids.shape[0]
    if not 1 <= d <= kernel.MAX_D:
        raise ValueError(f"assign: d={d} outside 1..{kernel.MAX_D}")
    if k < 1 or n >= 2**31 or k >= 2**31:
        raise ValueError(f"assign: n={n}, k={k} out of range")
    p = points.float()                     # upcast, as the reference does
    c = centroids.float()
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    partial_min = torch.empty(n, dtype=torch.float32, device=p.device)
    if n:
        kernel.assign_cuda(p, c, idx, partial_min)
        global LAUNCHES
        with _count_lock:
            LAUNCHES += 1
    # |p|^2 is constant per point: added back in f32 after the argmin
    return idx, partial_min + (p * p).sum(dim=1)
