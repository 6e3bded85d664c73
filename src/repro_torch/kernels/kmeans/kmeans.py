"""CUDA K-Means assignment kernels: build, bind and launch.

The Hopper counterpart of ``repro.kernels.kmeans.kmeans.assign_pallas``.
``csrc/kmeans_assign.cu`` holds two kernels and their plain C entry
points, compiled with nvcc for sm_90a at first use and bound with ctypes:

- the scan: ``bn`` threads per block, each holding :func:`rows` points in
  registers; tiles of ``bk`` centroids staged in shared memory packed as
  ``(-2 c, |c|^2)`` float4s; an argmin over groups of :data:`GROUP`
  centroids that keeps the first index of a tie; k split into ``splits``
  contiguous ranges across blocks (grid ``(point blocks, splits)``);
- the merge: with more than one split, each point's partial minima in
  split order with a strict ``<``, then ``|p|^2`` added.

:func:`assign_cuda` launches both (the merge only with more than one
split) in one call on PyTorch's current stream; :func:`merge_cuda`
launches the merge alone.  The public wrapper with its checks is
:func:`..ops.assign`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "kmeans_assign.cu"
MAX_THREADS = 512    # KM_MAX_THREADS: the largest bn
MAX_D = 32           # KM_MAX_D: the widest point the kernel is built for
SMEM_MAX = 49152     # KM_SMEM_MAX: shared bytes a block may use (no opt-in)
GROUP = 4            # KM_GROUP: centroids per argmin group; bk a multiple
MAX_SPLITS = 65535   # KM_MAX_SPLITS: the grid's second dimension
WARP = 32


def rows(d: int) -> int:
    """Points each thread holds at width d (``km_rows``): 4 up to d = 8,
    fewer for wider points, so the registers do not spill."""
    return 4 if d <= 8 else 2 if d <= 16 else 1


def smem_bytes(bk: int, d: int) -> int:
    """Shared memory of one block: bk packed centroids of
    ceil((d + 1) / 4) float4s each."""
    return 16 * bk * ((d + 4) // 4)


def accepts(bn: int, bk: int, d: int) -> bool:
    """Whether the scan takes these blocks at width d: bn whole warps up
    to MAX_THREADS, bk a multiple of GROUP, the tile within SMEM_MAX."""
    return (WARP <= bn <= MAX_THREADS and bn % WARP == 0
            and bk >= GROUP and bk % GROUP == 0 and 1 <= d <= MAX_D
            and smem_bytes(bk, d) <= SMEM_MAX)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built
    and bound once per process)."""
    lib = build.load(SOURCE)
    lib.kmeans_assign_f32.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5)
    lib.kmeans_assign_f32.restype = ctypes.c_int
    lib.kmeans_merge_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    lib.kmeans_merge_f32.restype = ctypes.c_int
    consts = ("kmeans_assign_max_d", "kmeans_assign_max_threads",
              "kmeans_assign_smem_max", "kmeans_assign_group")
    for name in consts:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.kmeans_assign_rows.argtypes = [ctypes.c_int]
    lib.kmeans_assign_rows.restype = ctypes.c_int
    lib.kmeans_assign_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.kmeans_assign_smem_bytes.restype = ctypes.c_long
    widths = range(1, MAX_D + 1)
    if tuple(getattr(lib, name)() for name in consts) != (
            MAX_D, MAX_THREADS, SMEM_MAX, GROUP) or any(
            lib.kmeans_assign_rows(d) != rows(d)
            or lib.kmeans_assign_smem_bytes(64, d) != smem_bytes(64, d)
            for d in widths):
        raise RuntimeError("kmeans_assign.cu constants disagree with "
                           f"MAX_D={MAX_D}, MAX_THREADS={MAX_THREADS}, "
                           f"SMEM_MAX={SMEM_MAX}, GROUP={GROUP}, rows() or "
                           "smem_bytes()")
    return lib


def _launch(device: torch.device, fn, *args) -> int:
    """Call the C entry `fn` with PyTorch's current stream on `device`
    appended, with `device` current (switched to only when it is not:
    the switch and the stream object cost more host time than the
    launch)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def partials(splits: int, n: int, device) -> Optional[torch.Tensor]:
    """Scratch for the scan's (splits, n) partials, both in one int32
    allocation: [0] the indices, [1] the minima's f32 bits; None with one
    split, where the scan writes the result itself."""
    if splits == 1:
        return None
    return torch.empty((2, splits, n), dtype=torch.int32, device=device)


def assign_cuda(points: torch.Tensor, centroids: torch.Tensor,
                idx_out: torch.Tensor, min_out: torch.Tensor, *,
                bn: int, bk: int, part: Optional[torch.Tensor]) -> None:
    """Launch K1 in one call into the library: contiguous f32 points (n, d)
    and centroids (k, d) on one CUDA device -> idx_out (n,) int32 and
    min_out (n,) f32, the squared distance.  ``part`` (from
    :func:`partials`) sets the split count: with None the scan writes the
    result; with (2, splits, n) it writes each centroid range's partial
    (index, least score ``|c|^2 - 2 p.c``) there and the merge reduces
    them into the outputs.  The caller has validated the arguments.
    Raises if a launch is refused."""
    lib = library()
    n, d = points.shape
    k = centroids.shape[0]
    splits = 1 if part is None else part.shape[1]
    ptrs = (0, 0) if part is None else (part[0].data_ptr(),
                                        part[1].data_ptr())
    err = _launch(points.device, lib.kmeans_assign_f32, points.data_ptr(),
                  centroids.data_ptr(), n, k, d, bn, bk, splits, *ptrs,
                  idx_out.data_ptr(), min_out.data_ptr())
    if err != 0:
        raise RuntimeError(f"kmeans_assign_f32 launch failed: CUDA error "
                           f"{err} (n={n}, k={k}, d={d}, bn={bn}, bk={bk}, "
                           f"splits={splits})")


def merge_cuda(points: torch.Tensor, part_idx: torch.Tensor,
               part_min: torch.Tensor, idx_out: torch.Tensor,
               min_out: torch.Tensor) -> None:
    """Launch the merge alone: points (n, d) f32 and the scan's (splits,
    n) partials -> idx_out (n,) int32 and min_out (n,) f32, the squared
    distance (:func:`assign_cuda` launches it itself; this entry serves
    a check of the merge on its own).  Raises if the launch is refused."""
    lib = library()
    n, d = points.shape
    splits = part_idx.shape[0]
    err = _launch(points.device, lib.kmeans_merge_f32, points.data_ptr(),
                  part_idx.data_ptr(), part_min.data_ptr(), n, d, splits,
                  idx_out.data_ptr(), min_out.data_ptr())
    if err != 0:
        raise RuntimeError(f"kmeans_merge_f32 launch failed: CUDA error "
                           f"{err} (n={n}, d={d}, splits={splits})")
