"""CUDA Mamba selective-scan kernel: build, bind and launch.

The Hopper counterpart of
``repro.kernels.mamba_scan.mamba_scan.mamba_scan_pallas``:
``csrc/mamba_scan.cu`` holds the kernel (one lane per (batch, d_inner,
state) element, h in a register across the whole sequence, the readout a
warp-shuffle sum over the state lanes) and a plain C entry point,
compiled with nvcc for sm_90a at first use and bound with ctypes.
:func:`scan_cuda` launches it on PyTorch's current stream; the public
wrapper with its checks is :func:`..ops.scan`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
MAX_THREADS = 512       # MS_MAX_THREADS: the largest block
MAX_ST = 32             # MS_MAX_ST: the widest state the kernel is built for
BS_BUILT = (4, 8, 16)   # the time steps a lane can load ahead (bs)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def state_lanes(st: int) -> int:
    """Lanes a d_inner row takes: st rounded up to a power of two, >= 2."""
    p = 2
    while p < st:
        p *= 2
    return p


def threads(bdi: int, st: int) -> int:
    """Threads of one block of bdi rows: whole warps."""
    return -(-bdi * state_lanes(st) // 32) * 32


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built
    and bound once per process)."""
    lib = build.load(SOURCE)
    fn = lib.mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    consts = ("mamba_scan_max_threads", "mamba_scan_max_st")
    for name in consts:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if tuple(getattr(lib, name)() for name in consts) != (MAX_THREADS,
                                                          MAX_ST):
        raise RuntimeError("mamba_scan.cu constants disagree with "
                           f"MAX_THREADS={MAX_THREADS}, MAX_ST={MAX_ST}")
    return lib


def scan_cuda(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
              h0: torch.Tensor, y: torch.Tensor, h_last: torch.Tensor, *,
              bdi: int, bs: int) -> None:
    """Launch the kernel: contiguous a, b (B, S, di, st), C (B, S, st),
    h0 (B, di, st) of one dtype on one CUDA device -> y (B, S, di) and
    h_last (B, di, st), both f32.  The caller has validated the
    arguments.  Raises if the launch is refused."""
    lib = library()
    B, S, di, st = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.mamba_scan_fwd(
            a.data_ptr(), b.data_ptr(), C.data_ptr(), h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), B, S, di, st,
            _DTYPES[a.dtype], bdi, bs, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_fwd launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, di={di}, st={st}, bdi={bdi}, "
                           f"bs={bs})")
