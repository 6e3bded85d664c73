"""Plain K-Means (Lloyd's algorithm) to hold the analytics engine's fits
against: the same points, the same initial centroids, exact distances.

It imports nothing of the program.  Its initial centroids are worked
out again from the fit's seed by the draw the analytics engine states
(the first k of a ``torch.randperm(n)`` on a CPU generator seeded with
the fit's seed).  ``precision="float64"`` is the reference;
``precision="tf32"`` computes the distances and the centroid sums as
float32 products on the tensor cores' TF32 path, the control.
"""
from __future__ import annotations

from typing import Tuple

import torch


def initial_indices(n: int, k: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:k]


def _sq_dist(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances: |p|^2 - 2 p.c + |c|^2."""
    return ((p * p).sum(1, keepdim=True) - 2.0 * (p @ c.T)
            + (c * c).sum(1)[None, :])


def fit(points: torch.Tensor, k: int, seed: int, iters: int, *,
        precision: str = "float64") -> Tuple[torch.Tensor, float]:
    """(centroids, cost): `iters` rounds of assign then update; the cost
    is the summed squared distance of the last round's assignment, and a
    cluster that gets no point keeps its centroid.  Points are taken in
    blocks of 2^24 / k rows, so the distances fit at any size."""
    if precision == "float64":
        dtype, tf32 = torch.float64, False
    elif precision == "tf32":
        dtype, tf32 = torch.float32, True
    else:
        raise ValueError(precision)
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        p = points.to(dtype)
        c = p[initial_indices(p.shape[0], k, seed).to(p.device)]
        cost = float("inf")
        rows = max(256, (1 << 24) // k)
        for _ in range(iters):
            sums = torch.zeros_like(c)
            counts = torch.zeros(k, dtype=dtype, device=p.device)
            total = torch.zeros((), dtype=torch.float64, device=p.device)
            for lo in range(0, p.shape[0], rows):
                blk = p[lo:lo + rows]
                d = _sq_dist(blk, c)
                mind, idx = d.min(dim=1)
                onehot = torch.nn.functional.one_hot(idx, k).to(dtype)
                sums += onehot.T @ blk
                counts += onehot.sum(0)
                total += mind.clamp_min(0).sum().double()
            cost = float(total)
            c = torch.where(counts[:, None] > 0,
                            sums / counts[:, None].clamp(min=1.0), c)
        return c, cost
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep[0]
        torch.backends.cudnn.allow_tf32 = keep[1]
