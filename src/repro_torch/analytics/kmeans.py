"""K-Means on the analytics engine — the paper's evaluation workload (Fig 6).

Each iteration is one MapReduce round, exactly as the paper's Hadoop
implementation: map = assign points to nearest centroid + emit partial
(sum, count) per cluster; shuffle/reduce = aggregate partials; driver =
recompute centroids.  The distance/assignment hot-spot runs through the
hand-written CUDA kernel (kernels/kmeans) when enabled, else the plain
PyTorch version.

The paper's three scenarios (points x clusters, constant product):
10,000 x 5,000 / 100,000 x 500 / 1,000,000 x 50, d=3, 2 iterations.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.core.dataplane import ShardedTensor
from .engine import AnalyticsEngine

PAPER_SCENARIOS = {
    "10k_points_5k_clusters": (10_000, 5_000),
    "100k_points_500_clusters": (100_000, 500),
    "1m_points_50_clusters": (1_000_000, 50),
}
PAPER_DIM = 3
PAPER_ITERS = 2


def assign_partials(points: torch.Tensor, centroids: torch.Tensor, *,
                    use_kernel: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map phase: per-block partial (sums, counts, sq-dist cost)."""
    # float32 products stay full float32 on the card (no TF32), as the
    # reference's products are; set explicitly rather than trusting the
    # process default
    torch.backends.cuda.matmul.allow_tf32 = False
    if use_kernel:
        from repro_torch.kernels.kmeans import ops
        assign, mind = ops.assign(points, centroids)
    else:
        from repro_torch.kernels.kmeans import ref
        assign, mind = ref.assign(points, centroids)
    k = centroids.shape[0]
    # the one-hot product, as the reference's einsum: a plain matmul,
    # and deterministic on the card where index_add_'s atomics are not
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(points.dtype)
    sums = onehot.T @ points                                      # (k, d)
    counts = onehot.sum(dim=0)
    return sums, counts, mind.sum()


def _init_centroids(pts: ShardedTensor, k: int, seed: int) -> torch.Tensor:
    """k distinct points drawn without replacement (a torch.Generator
    seeded with `seed`), on the dataset's first device."""
    n = pts.shape[0]
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=gen)[:k]
    full = pts.full()
    return full[idx.to(full.device)]


def kmeans_fit(engine: AnalyticsEngine, name: str, k: int, *,
               iters: int = PAPER_ITERS, data_path: str = "local",
               use_kernel: bool = False, seed: int = 0,
               ) -> Tuple[torch.Tensor, float]:
    """Run K-Means over a registered dataset. Returns (centroids, cost).

    data_path='local'  — compute on resident blocks (RP-YARN / local disk)
    data_path='global' — force a full redistribution first, each iteration
                         (RP / Lustre): same math, measured data movement.
    """
    pts = engine.get(name)
    centroids = _init_centroids(pts, k, seed)

    cost = torch.tensor(float("inf"))
    map_fn = functools.partial(assign_partials, use_kernel=use_kernel)
    for _ in range(iters):
        if data_path == "global":
            engine.global_reshard(name)
        sums, counts, cost = engine.map_reduce(
            map_fn, name, extra_args=(centroids,),
            cache_key=("kmeans_assign", use_kernel))
        centroids = torch.where(counts[:, None] > 0,
                                sums / counts[:, None].clamp(min=1.0),
                                centroids)
    return centroids, float(cost)


def make_dataset(n: int, d: int = PAPER_DIM, *, n_clusters: int = 8,
                 seed: int = 0, device="cuda") -> torch.Tensor:
    """Synthetic mixture-of-Gaussians points (paper uses synthetic data),
    drawn on `device` from a generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.rand((n_clusters, d), generator=gen, device=device) \
        * 10.0 - 5.0
    which = torch.randint(0, n_clusters, (n,), generator=gen, device=device)
    noise = torch.randn((n, d), generator=gen, device=device) * 0.3
    return centers[which] + noise
