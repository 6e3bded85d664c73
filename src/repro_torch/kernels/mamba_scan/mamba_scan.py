"""CUDA Mamba selective-scan kernel: build, bind and launch.

The Hopper counterpart of
``repro.kernels.mamba_scan.mamba_scan.mamba_scan_pallas``:
``csrc/mamba_scan.cu`` holds the kernel (one lane per (batch, d_inner,
state) element, h in a register across the whole sequence, the readout a
warp-shuffle sum over the state lanes) and a plain C entry point,
compiled with nvcc for sm_90a at first use and bound with ctypes.
:func:`scan_cuda` launches it on PyTorch's current stream; the public
wrapper with its checks is :func:`..ops.scan`.

The same source holds K3's fused mode: it reads the layer's own inputs
(dt, A, u, Bc, C, h0) and forms ``a = exp(dt A)`` and ``b = u Bc`` in
registers, :data:`FUSED_STATES` states a lane, dt, u, Bc and C staged a
chunk of steps ahead in shared memory.  :func:`scan_fused_cuda`
launches it; the public wrapper is :func:`..ops.selective_scan`.

``csrc/mamba_scan_bwd.cu`` is its backward (K3-bwd): h checkpointed every
:data:`BWD_CHUNK` steps by a forward walk, each chunk rebuilt in
registers and walked backwards, dC reduced over d_inner in block order
by a second small kernel.  :func:`scan_backward_cuda` launches the pair;
the public wrapper is :func:`..ops.scan_backward`.

``csrc/mamba_ssm_bwd.cu`` is the model path's backward: the gradient of
the scan and its input tail ``a = exp(dt A)``, ``b = u Bc`` together,
rebuilding a and b in registers so that no (B, S, d_inner, d_state)
tensor is read or written.  :func:`ssm_backward_cuda` launches it; the
public wrapper is :func:`..ops.ssm_backward`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

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
SSM_BWD_SOURCE = SOURCE.with_name("mamba_ssm_bwd.cu")
SSM_CHUNK = 16          # MSS_T: steps between the fused backward's checkpoints
SSM_THREADS = 128       # MSS_THREADS: threads a block
FUSED_STATES = 4        # MSF_P: states a lane in the fused mode, at most
FUSED_BS_BUILT = (16, 32, 64)   # the steps a staged chunk holds (bs)
FUSED_MAX_SMEM = 232_448        # MSF_MAX_SMEM: a block's shared memory


def state_lanes(st: int) -> int:
    """Lanes a d_inner row takes: st rounded up to a power of two, >= 2."""
    p = 2
    while p < st:
        p *= 2
    return p


def threads(bdi: int, st: int) -> int:
    """Threads of one block of bdi rows: whole warps."""
    return -(-bdi * state_lanes(st) // 32) * 32


def fused_lanes(st: int) -> Tuple[int, int]:
    """(lanes a row, states a lane) of the fused mode: the row's
    state_lanes(st) states, at most FUSED_STATES to a lane."""
    stp = state_lanes(st)
    p = min(FUSED_STATES, stp)
    return stp // p, p


def fused_threads(bdi: int, st: int) -> int:
    """Threads of one fused-mode block of bdi rows: whole warps."""
    return -(-bdi * fused_lanes(st)[0] // 32) * 32


def fused_smem_bytes(bdi: int, st: int, bs: int) -> int:
    """Shared memory of one fused-mode block: two stages of dt and u
    (bs x bdi) and Bc and C (bs x state_lanes(st)), f32."""
    return 2 * 4 * (2 * bs * bdi + 2 * bs * state_lanes(st))


def fused_accepts(bdi: int, st: int, bs: int) -> bool:
    """Whether the fused mode is built for bdi rows a block and chunks of
    bs steps at state width st."""
    return (isinstance(bdi, int) and 1 <= bdi <= MAX_THREADS
            and bs in FUSED_BS_BUILT and 1 <= st <= MAX_ST
            and fused_threads(bdi, st) <= MAX_THREADS
            and fused_smem_bytes(bdi, st, bs) <= FUSED_MAX_SMEM)


def balanced_rows(B: int, di: int, st: int, bs: int, sms: int) -> int:
    """Rows a fused-mode block that spread the B x di rows evenly over
    the card's `sms` SMs, one block an SM as far as a block holds them:
    ceil(B di / sms), rounded up to a multiple of 4 (whole 16-byte
    copies), at most the rows a block of MAX_THREADS threads or
    FUSED_MAX_SMEM bytes holds, and at most di rounded up to 4."""
    stp = state_lanes(st)
    cap = min(MAX_THREADS // fused_lanes(st)[0],
              (FUSED_MAX_SMEM // 8 - 2 * bs * stp) // (2 * bs))
    rows = -(-B * di // sms)
    rows = -(-rows // 4) * 4
    return max(1, min(rows, cap // 4 * 4, -(-di // 4) * 4))


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built
    and bound once per process)."""
    lib = build.load(SOURCE)
    fn = lib.mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mamba_scan_fused_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    consts = ("mamba_scan_max_threads", "mamba_scan_max_st",
              "mamba_scan_fused_states")
    for name in consts:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if tuple(getattr(lib, name)() for name in consts) != (
            MAX_THREADS, MAX_ST, FUSED_STATES):
        raise RuntimeError("mamba_scan.cu constants disagree with "
                           f"MAX_THREADS={MAX_THREADS}, MAX_ST={MAX_ST}, "
                           f"FUSED_STATES={FUSED_STATES}")
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


def scan_fused_cuda(dt, A, u, Bc, C, h0, y, h_last, *, bdi: int,
                    bs: int) -> None:
    """Launch the fused mode: contiguous f32 dt, u (B, S, di), A
    (di, st), Bc, C (B, S, st), h0 (B, di, st) on one CUDA device -> y
    (B, S, di) and h_last (B, di, st), f32; bdi rows a block, bs steps a
    staged chunk.  The caller has validated the arguments.  Raises if the
    launch is refused."""
    lib = library()
    B, S, di = dt.shape
    st = A.shape[1]
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.mamba_scan_fused_fwd(
            dt.data_ptr(), A.data_ptr(), u.data_ptr(), Bc.data_ptr(),
            C.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            B, S, di, st, bdi, bs, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_fused_fwd launch failed: CUDA error "
                           f"{err} (B={B}, S={S}, di={di}, st={st}, "
                           f"bdi={bdi}, bs={bs})")


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


@functools.cache
def library_ssm_bwd() -> ctypes.CDLL:
    """The built fused-backward library with its C signatures declared."""
    lib = build.load(SSM_BWD_SOURCE)
    lib.mamba_ssm_bwd.argtypes = [ctypes.c_void_p] * 17 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.mamba_ssm_bwd.restype = ctypes.c_int
    for name in ("mamba_ssm_bwd_layout", "mamba_ssm_bwd_occupancy"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)]
        getattr(lib, name).restype = ctypes.c_int
    lib.mamba_ssm_bwd_decay.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.mamba_ssm_bwd_decay.restype = ctypes.c_int
    consts = ("mamba_ssm_bwd_max_st", "mamba_ssm_bwd_chunk",
              "mamba_ssm_bwd_threads")
    for name in consts:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if tuple(getattr(lib, name)() for name in consts) != (
            MAX_ST, SSM_CHUNK, SSM_THREADS):
        raise RuntimeError("mamba_ssm_bwd.cu constants disagree with "
                           f"MAX_ST={MAX_ST}, SSM_CHUNK={SSM_CHUNK}, "
                           f"SSM_THREADS={SSM_THREADS}")
    return lib


def ssm_layout(di: int, st: int) -> dict:
    """The fused backward's launch layout, from the kernel library:
    rows a block, blocks along d_inner, blocks a cluster, clusters along
    d_inner, bytes of shared memory, padded state width, states a
    lane."""
    out = (ctypes.c_int * 7)()
    if library_ssm_bwd().mamba_ssm_bwd_layout(di, st, out) != 0:
        raise ValueError(f"mamba_ssm_bwd: no layout for di={di}, st={st}")
    return dict(zip(("rows", "blocks", "cluster", "clusters", "smem",
                     "st_pad", "lane_states"), out))


def ssm_occupancy(di: int, st: int) -> dict:
    """Blocks of the fused backward resident on one SM and clusters
    resident on the card at once, for its launch at (di, st), from the
    CUDA occupancy calculator."""
    out = (ctypes.c_int * 2)()
    err = library_ssm_bwd().mamba_ssm_bwd_occupancy(di, st, out)
    if err != 0:
        raise RuntimeError(f"mamba_ssm_bwd_occupancy: CUDA error {err}")
    return {"blocks_per_sm": out[0], "resident_clusters": out[1]}


def ssm_backward_cuda(dt, A, u, Bc, C, h0, dy, dh_last, ddt, du, dBc, dC,
                      dA, dh0) -> None:
    """Launch the fused backward and its summing kernel: contiguous f32
    dt, u (B, S, di), A (di, st), Bc, C (B, S, st), h0 (B, di, st); dy
    (B, S, di) and dh_last (B, di, st) f32 or None (zero); outputs ddt,
    du, dBc, dC, dA and, unless None, dh0.  Allocates the scratch (h
    checkpoints, the clusters' partials of dBc and dC, dA's batch
    partials).  The caller has validated the arguments.  Raises if a
    launch is refused."""
    lib = library_ssm_bwd()
    B, S, di = dt.shape
    st = A.shape[-1]
    lay = ssm_layout(di, st)
    dev = dt.device
    hck = torch.empty((B, -(-S // SSM_CHUNK), di, st), dtype=torch.float32,
                      device=dev)
    part = torch.empty((B, S, lay["clusters"], 2 * lay["st_pad"]),
                       dtype=torch.float32, device=dev)
    dA_part = torch.empty((B, di, st), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mamba_ssm_bwd(
            dt.data_ptr(), A.data_ptr(), u.data_ptr(), Bc.data_ptr(),
            C.data_ptr(), h0.data_ptr(), _ptr(dy), _ptr(dh_last),
            ddt.data_ptr(), du.data_ptr(), dBc.data_ptr(), dC.data_ptr(),
            dA.data_ptr(), _ptr(dh0), hck.data_ptr(), part.data_ptr(),
            dA_part.data_ptr(), B, S, di, st, stream)
    if err != 0:
        raise RuntimeError(f"mamba_ssm_bwd launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, di={di}, st={st})")


def decay_cuda(dt: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The fused backward's own exp(dt * A), (..., di, st) f32, for a
    check against ``torch.exp(dt[..., None] * A)`` on the card."""
    di, st = A.shape
    a = torch.empty((*dt.shape, st), dtype=torch.float32, device=dt.device)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = library_ssm_bwd().mamba_ssm_bwd_decay(
            dt.data_ptr(), A.data_ptr(), a.data_ptr(), dt.numel() // di, di,
            st, stream)
    if err != 0:
        raise RuntimeError(f"mamba_ssm_bwd_decay launch failed: CUDA error "
                           f"{err}")
    return a
