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
