"""The plain PyTorch version of the K-Means assignment kernel (its oracle)."""
from __future__ import annotations

from typing import Tuple

import torch


def assign(points: torch.Tensor, centroids: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points: (n, d), centroids: (k, d) ->
    (nearest centroid id (n,) int32, squared distance to it (n,) f32).
    ``argmin`` returns the first index of a tie."""
    p = points.float()
    c = centroids.float()
    d2 = ((p * p).sum(dim=1, keepdim=True)
          - 2.0 * (p @ c.T)
          + (c * c).sum(dim=1)[None, :])                  # (n, k)
    idx = d2.argmin(dim=1)
    return idx.to(torch.int32), d2.gather(1, idx[:, None])[:, 0]


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 per row in f32, summed in column order as the kernels do."""
    x = x.float()
    s = x[:, 0] * x[:, 0]
    for j in range(1, x.shape[1]):
        s = s + x[:, j] * x[:, j]
    return s


def pack(centroids: torch.Tensor) -> torch.Tensor:
    """The scan's shared-memory layout: each centroid as
    ``(-2 c_0, ..., -2 c_{d-1}, |c|^2)``, zero-padded to a multiple of 4
    floats -> (k, 4 * ceil((d + 1) / 4)) f32."""
    c = centroids.float()
    k, d = c.shape
    out = torch.zeros(k, 4 * ((d + 4) // 4), dtype=torch.float32,
                      device=c.device)
    out[:, :d] = -2.0 * c
    out[:, d] = sq_norm(c)
    return out


def packed_scores(points: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Scores ``|c|^2 - 2 p.c`` (n, k) from the packed layout, accumulated
    from |c|^2 in column order as the scan does (without its fused
    multiply-adds)."""
    p = points.float()
    s = packed[None, :, p.shape[1]].expand(p.shape[0], -1)
    for j in range(p.shape[1]):
        s = s + p[:, j:j + 1] * packed[None, :, j]
    return s


def merge_partials(part_idx: torch.Tensor, part_min: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(splits, n) partial (index, minimum) -> (n,) each, taken in split
    order and replaced only on a strict ``<``: among equal minima the
    lower range, so the first index, wins."""
    idx, best = part_idx[0], part_min[0]
    for s in range(1, part_idx.shape[0]):
        take = part_min[s] < best
        idx = torch.where(take, part_idx[s], idx)
        best = torch.where(take, part_min[s], best)
    return idx, best


def merge(points: torch.Tensor, part_idx: torch.Tensor,
          part_min: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the merge kernel: :func:`merge_partials`, then
    |p|^2 added to the minimum in f32."""
    idx, best = merge_partials(part_idx, part_min)
    return idx, best + sq_norm(points)
