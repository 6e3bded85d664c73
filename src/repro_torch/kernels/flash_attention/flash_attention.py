"""CUDA flash-attention kernel: build, bind and launch.

The Hopper counterpart of
``repro.kernels.flash_attention.flash_attention.flash_attention_pallas``:
``csrc/flash_attention.cu`` holds the forward kernel (one warp per 16
query rows on ``mma.sync`` tensor cores, 3xTF32 for f32 and bf16 for
bf16, a 2-stage ``cp.async`` ring of K/V tiles in shared memory, online
softmax in f32 registers, the causal and window masks as key-loop
bounds) and a plain C entry point, compiled with nvcc for sm_90a at
first use and bound with ctypes.  :func:`attention_cuda` launches it on
PyTorch's current stream; the public wrapper with its checks is
:func:`..ops.attention`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_BQ = 128             # FA_MAX_BQ: the largest bq (8 warps of 16 rows)
WARP_ROWS = 16           # FA_WARP_ROWS: query rows per warp; bq is a multiple
BK_BUILT = (32, 64)      # FA_BK_BUILT: the key-tile sizes instantiated
SMEM_MAX = 232_448       # FA_SMEM_MAX: shared bytes a block may opt in to
HEAD_DIMS = (32, 64, 128)  # the head dims the kernel is built for
_PAD_BYTES = 16          # FA_PAD_BYTES: padding per staged row
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(bq: int, bk: int, hd: int, es: int = 4) -> int:
    """Shared memory of one block for elements of ``es`` bytes (4 for
    f32, the larger; 2 for bf16): the query tile and two stages of K and
    V tiles, every row padded by 16 bytes."""
    return (bq + 4 * bk) * (hd * es + _PAD_BYTES)


def accepts(bq: int, bk: int, hd: int, es: int = 4) -> bool:
    """Whether the kernel is built for these blocks at this head dim and
    element size: bq a multiple of 16 up to MAX_BQ, bk in BK_BUILT, and
    the shared memory within SMEM_MAX."""
    return (WARP_ROWS <= bq <= MAX_BQ and bq % WARP_ROWS == 0
            and bk in BK_BUILT and hd in HEAD_DIMS
            and smem_bytes(bq, bk, hd, es) <= SMEM_MAX)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built
    and bound once per process)."""
    lib = build.load(SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    consts = ("flash_attention_max_bq", "flash_attention_warp_rows",
              "flash_attention_smem_max")
    for name in consts:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.flash_attention_bk_built.argtypes = [ctypes.c_int]
    lib.flash_attention_bk_built.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.flash_attention_smem_bytes.restype = ctypes.c_long
    built = tuple(lib.flash_attention_bk_built(i)
                  for i in range(len(BK_BUILT) + 1))
    if tuple(getattr(lib, name)() for name in consts) != (
            MAX_BQ, WARP_ROWS, SMEM_MAX) or built != BK_BUILT + (0,) or any(
            lib.flash_attention_smem_bytes(bq, bk, hd, es)
            != smem_bytes(bq, bk, hd, es)
            for bq, bk, hd, es in ((128, 64, 64, 4), (48, 32, 128, 2))):
        raise RuntimeError("flash_attention.cu constants disagree with "
                           f"MAX_BQ={MAX_BQ}, WARP_ROWS={WARP_ROWS}, "
                           f"BK_BUILT={BK_BUILT}, SMEM_MAX={SMEM_MAX} or "
                           "smem_bytes()")
    return lib


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, *, causal: bool, window: int, bq: int,
                   bk: int) -> None:
    """Launch the kernel: contiguous, 16-byte aligned q (B, S_q, H, hd),
    k and v (B, S_k, H, hd) of one dtype on one CUDA device -> out, shaped
    and typed as q.  The caller has validated the arguments.  Raises if
    the launch is refused."""
    lib = library()
    B, S_q, H, hd = q.shape
    S_k = k.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            S_q, S_k, hd, _DTYPES[q.dtype], bq, bk, int(causal), window,
            hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err} (B={B}, H={H}, S_q={S_q}, S_k={S_k}, "
                           f"hd={hd}, bq={bq}, bk={bk})")
