"""CUDA Mamba selective-scan kernel: build, bind and launch.

The Hopper counterpart of
``repro.kernels.mamba_scan.mamba_scan.mamba_scan_pallas``:
``csrc/mamba_scan.cu`` holds the kernel (one lane per (batch, d_inner,
state) element, h in a register across the whole sequence, the readout a
warp-shuffle sum over the state lanes) and a plain C entry point,
compiled with nvcc for sm_90a at first use and bound with ctypes.
:func:`scan_cuda` launches it on PyTorch's current stream; the public
wrapper with its checks is :func:`..ops.scan`.

``csrc/mamba_scan_bwd.cu`` is its backward (K3-bwd): h checkpointed every
:data:`BWD_CHUNK` steps by a forward walk, each chunk rebuilt in
registers and walked backwards, dC reduced over d_inner in block order
by a second small kernel.  :func:`scan_backward_cuda` launches the pair;
the public wrapper is :func:`..ops.scan_backward`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
BWD_SOURCE = SOURCE.with_name("mamba_scan_bwd.cu")
MAX_THREADS = 512       # MS_MAX_THREADS: the largest block
MAX_ST = 32             # MS_MAX_ST: the widest state the kernel is built for
BS_BUILT = (4, 8, 16)   # the time steps a lane can load ahead (bs)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_THREADS = 256       # MSB_THREADS: the backward's block
BWD_CHUNK = 16          # MSB_T: steps between the backward's h checkpoints


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


def bwd_rows(st: int) -> int:
    """d_inner rows of one backward block: a full block of BWD_THREADS."""
    return BWD_THREADS // state_lanes(st)


@functools.cache
def library_bwd() -> ctypes.CDLL:
    """The built backward library with its C signatures declared."""
    lib = build.load(BWD_SOURCE)
    fn = lib.mamba_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    consts = ("mamba_scan_bwd_threads", "mamba_scan_bwd_max_st",
              "mamba_scan_bwd_chunk")
    for name in consts:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if tuple(getattr(lib, name)() for name in consts) != (
            BWD_THREADS, MAX_ST, BWD_CHUNK):
        raise RuntimeError("mamba_scan_bwd.cu constants disagree with "
                           f"BWD_THREADS={BWD_THREADS}, MAX_ST={MAX_ST}, "
                           f"BWD_CHUNK={BWD_CHUNK}")
    return lib


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def scan_backward_cuda(a, b, C, h0, dy, dh_last, da, db, dC, dh0, *,
                       bdi: int) -> None:
    """Launch the backward: contiguous a, b (B, S, di, st), C (B, S, st),
    h0 (B, di, st) of one dtype; dy (B, S, di) and dh_last (B, di, st)
    f32 or None (zero); da, db and, unless None, dC and dh0 in the
    inputs' dtype.  Allocates the kernel's scratch (the h checkpoints
    and dC's per-block partials).  The caller has validated the
    arguments.  Raises if a launch is refused."""
    lib = library_bwd()
    B, S, di, st = a.shape
    nc = -(-S // BWD_CHUNK)
    hck = torch.empty((B, nc, di, st), dtype=torch.float32, device=a.device)
    part = None if dC is None else torch.empty(
        (B, S, -(-di // bdi), st), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.mamba_scan_bwd(
            a.data_ptr(), b.data_ptr(), C.data_ptr(), h0.data_ptr(),
            _ptr(dy), _ptr(dh_last), da.data_ptr(), db.data_ptr(),
            _ptr(dC), _ptr(dh0), hck.data_ptr(), _ptr(part), B, S, di, st,
            _DTYPES[a.dtype], bdi, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, di={di}, st={st}, bdi={bdi})")
