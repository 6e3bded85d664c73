"""CUDA K-Means assignment kernel: build, bind and launch.

The Hopper counterpart of ``repro.kernels.kmeans.kmeans.assign_pallas``:
``csrc/kmeans_assign.cu`` holds the kernel (one thread per point, ``bn``
points per block, tiles of ``bk`` centroids staged in shared memory,
first index wins a tie) and a plain C entry point, compiled with nvcc for sm_90a at first use and
bound with ctypes.  :func:`assign_cuda` launches it on PyTorch's current
stream; the public wrapper with its checks is :func:`..ops.assign`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "kmeans_assign.cu"
MAX_THREADS = 512    # KM_MAX_THREADS: the largest bn (one thread a point)
MAX_D = 32           # KM_MAX_D: the widest point the kernel is built for
SMEM_MAX = 49152     # KM_SMEM_MAX: shared bytes a block may use (no opt-in)


def smem_bytes(bk: int, d: int) -> int:
    """Shared memory of one block: a tile of bk centroids and their norms."""
    return 4 * bk * (d + 1)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built
    and bound once per process)."""
    lib = build.load(SOURCE)
    fn = lib.kmeans_assign_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    consts = ("kmeans_assign_max_d", "kmeans_assign_max_threads",
              "kmeans_assign_smem_max")
    for name in consts:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if tuple(getattr(lib, name)() for name in consts) != (
            MAX_D, MAX_THREADS, SMEM_MAX):
        raise RuntimeError("kmeans_assign.cu constants disagree with "
                           f"MAX_D={MAX_D}, MAX_THREADS={MAX_THREADS}, "
                           f"SMEM_MAX={SMEM_MAX}")
    return lib


def assign_cuda(points: torch.Tensor, centroids: torch.Tensor,
                idx_out: torch.Tensor, min_out: torch.Tensor, *,
                bn: int, bk: int) -> None:
    """Launch the kernel: contiguous f32 points (n, d) and centroids
    (k, d) on one CUDA device -> idx_out (n,) int32 and min_out (n,) f32,
    the least score ``-2 p.c + |c|^2`` (without ``|p|^2``), with bn
    points per block and bk centroids per shared-memory tile.  The caller
    has validated the arguments.  Raises if the launch is refused."""
    lib = library()
    n, d = points.shape
    k = centroids.shape[0]
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.kmeans_assign_f32(points.data_ptr(), centroids.data_ptr(),
                                    n, k, d, bn, bk, idx_out.data_ptr(),
                                    min_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign_f32 launch failed: CUDA error "
                           f"{err} (n={n}, k={k}, d={d}, bn={bn}, bk={bk})")
