"""Public wrapper for the K-Means assignment kernels.

For a CUDA tensor :func:`assign` launches the hand-written scan
(:mod:`.kmeans`), and the merge when k is split across blocks, or raises —
it never falls back.  For a CPU tensor it runs the plain version
(:mod:`.ref`), which is what the CPU tests reach.  ``LAUNCHES`` counts
the scan's launches and ``MERGE_LAUNCHES`` the merge's, and nothing else,
so a run can show that its main path went through both.
"""
from __future__ import annotations

import functools
import threading
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import autotune
from . import kmeans as kernel
from . import ref

LAUNCHES = 0
MERGE_LAUNCHES = 0
_count_lock = threading.Lock()

# blocks per SM that split_count aims for: several small blocks per SM
# even out the SMs' shares of the work
BLOCKS_PER_SM = 4


def resolve_blocks(n: int, k: int, d: int, dtype: torch.dtype, device,
                   bn: Optional[int], bk: Optional[int]) -> Tuple[int, int]:
    """Block sizes for assignment: explicit args win, else the autotune
    registry, else :data:`autotune.DEFAULTS`.  A registry entry the scan
    does not take (:func:`.kmeans.accepts`, say one tuned for an older
    kernel) counts as a miss.  Every choice gives bitwise the same result;
    only the time differs."""
    if bn is None or bk is None:
        tuned = autotune.lookup("kmeans", {"n": n, "k": k, "d": d}, dtype,
                                device)
        if tuned is None or not kernel.accepts(tuned.get("bn", 0),
                                               tuned.get("bk", 0), d):
            tuned = autotune.DEFAULTS["kmeans"]
        bn = bn if bn is not None else tuned["bn"]
        bk = bk if bk is not None else tuned["bk"]
    return bn, bk


def max_splits(k: int, bk: int) -> int:
    """The most splits the scan takes: one per centroid tile."""
    return min(-(-k // bk), kernel.MAX_SPLITS)


def split_count(n: int, k: int, bn: int, bk: int, r: int, sms: int) -> int:
    """How many ranges to split k into: enough (point blocks x splits) for
    :data:`BLOCKS_PER_SM` blocks on each of ``sms`` SMs, at least 1 and at
    most :func:`max_splits`.  Not a tuned knob: it follows from the
    blocks and the card."""
    blocks = max(1, -(-n // (bn * r)))
    want = -(-BLOCKS_PER_SM * sms // blocks)
    return max(1, min(want, max_splits(k, bk)))


def split_ranges(k: int, splits: int) -> List[Tuple[int, int]]:
    """The centroid range [lo, hi) of each split, as the scan computes
    it: split s takes the groups of GROUP centroids
    [s * G / splits, (s + 1) * G / splits) of G = ceil(k / GROUP)."""
    g = kernel.GROUP
    groups = -(-k // g)
    return [(g * (s * groups // splits),
             min(k, g * ((s + 1) * groups // splits)))
            for s in range(splits)]


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def assign(points: torch.Tensor, centroids: torch.Tensor, *,
           bn: Optional[int] = None, bk: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: points (n, d), centroids (k, d), f32
    or bf16 (upcast to f32) -> (idx (n,) int32, squared distance (n,) f32).
    The first index wins a tie.  bn threads per block and bk centroids per
    shared-memory tile (resolved by :func:`resolve_blocks`); k split into
    :func:`split_count` ranges across blocks."""
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
    bn, bk = resolve_blocks(n, k, d, points.dtype, points.device, bn, bk)
    if not kernel.accepts(bn, bk, d):
        raise ValueError(f"assign: bn={bn}, bk={bk} outside the kernel's "
                         f"limits (bn whole warps <= {kernel.MAX_THREADS}, "
                         f"bk a multiple of {kernel.GROUP}, "
                         f"{kernel.SMEM_MAX} bytes of shared memory)")
    splits = split_count(n, k, bn, bk, kernel.rows(d),
                         sm_count(points.device.index
                                  if points.device.index is not None
                                  else torch.cuda.current_device()))
    p = points.float()                     # upcast, as the reference does
    c = centroids.float()
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if not n:
        return idx, dist
    kernel.assign_cuda(p, c, idx, dist, bn=bn, bk=bk,
                       part=kernel.partials(splits, n, p.device))
    global LAUNCHES, MERGE_LAUNCHES
    with _count_lock:
        LAUNCHES += 1
        MERGE_LAUNCHES += splits > 1
    return idx, dist
