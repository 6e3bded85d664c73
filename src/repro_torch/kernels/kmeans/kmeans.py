"""CUDA K-Means assignment kernel: build, bind and launch.

The Hopper counterpart of ``repro.kernels.kmeans.kmeans.assign_pallas``:
``csrc/kmeans_assign.cu`` holds the kernel (one thread per point,
centroid tiles staged in shared memory, first index wins a tie) and a
plain C entry point, compiled with nvcc for sm_90a at first use and
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
THREADS = 256   # KM_THREADS: points per CUDA block (one thread each)
MAX_D = 32      # KM_MAX_D: the widest point the kernel is built for


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built
    and bound once per process)."""
    lib = build.load(SOURCE)
    fn = lib.kmeans_assign_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("kmeans_assign_max_d", "kmeans_assign_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if (lib.kmeans_assign_max_d(), lib.kmeans_assign_threads()) != (MAX_D,
                                                                    THREADS):
        raise RuntimeError("kmeans_assign.cu constants disagree with "
                           f"MAX_D={MAX_D}, THREADS={THREADS}")
    return lib


def assign_cuda(points: torch.Tensor, centroids: torch.Tensor,
                idx_out: torch.Tensor, min_out: torch.Tensor) -> None:
    """Launch the kernel: contiguous f32 points (n, d) and centroids
    (k, d) on one CUDA device -> idx_out (n,) int32 and min_out (n,) f32,
    the least score ``-2 p.c + |c|^2`` (without ``|p|^2``).  The caller
    has validated the arguments.  Raises if the launch is refused."""
    lib = library()
    n, d = points.shape
    k = centroids.shape[0]
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.kmeans_assign_f32(points.data_ptr(), centroids.data_ptr(),
                                    n, k, d, idx_out.data_ptr(),
                                    min_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign_f32 launch failed: CUDA error "
                           f"{err} (n={n}, k={k}, d={d})")
