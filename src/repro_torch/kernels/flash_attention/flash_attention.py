"""CUDA flash-attention kernel: build, bind and launch.

The Hopper counterpart of
``repro.kernels.flash_attention.flash_attention.flash_attention_pallas``:
``csrc/flash_attention.cu`` holds the forward kernel (one thread per
query row, K/V tiles in shared memory, online softmax in f32, the
causal and window masks as key-loop bounds) and a plain C entry point,
compiled with nvcc for sm_90a at first use and bound with ctypes.
:func:`attention_cuda` launches it on PyTorch's current stream; the
public wrapper with its checks is :func:`..ops.attention`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_THREADS = 256        # FA_MAX_THREADS: the largest bq (one thread a row)
KEY_CHUNK = 8            # FA_KC: keys a thread takes at a time
SMEM_MAX = 232_448       # FA_SMEM_MAX: shared bytes a block may opt in to
HEAD_DIMS = (32, 64, 128)  # the head dims the kernel is built for
_QPAD = 4                # FA_QPAD: floats of padding per staged query row
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(bq: int, bk: int, hd: int) -> int:
    """Shared memory of one block: the padded query tile and the K and V
    tiles (bk rounded up to the key chunk), all f32."""
    bkp = -(-bk // KEY_CHUNK) * KEY_CHUNK
    return 4 * (bq * (hd + _QPAD) + 2 * bkp * hd)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built
    and bound once per process)."""
    lib = build.load(SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    consts = ("flash_attention_max_threads", "flash_attention_key_chunk",
              "flash_attention_smem_max")
    for name in consts:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_smem_bytes.restype = ctypes.c_long
    if tuple(getattr(lib, name)() for name in consts) != (
            MAX_THREADS, KEY_CHUNK, SMEM_MAX) or any(
            lib.flash_attention_smem_bytes(bq, bk, hd) != smem_bytes(bq, bk, hd)
            for bq, bk, hd in ((128, 32, 64), (64, 20, 128))):
        raise RuntimeError("flash_attention.cu constants disagree with "
                           f"MAX_THREADS={MAX_THREADS}, KEY_CHUNK={KEY_CHUNK},"
                           f" SMEM_MAX={SMEM_MAX} or smem_bytes()")
    return lib


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, *, causal: bool, window: int, bq: int,
                   bk: int) -> None:
    """Launch the kernel: contiguous q (B, S_q, H, hd), k and v
    (B, S_k, H, hd) of one dtype on one CUDA device -> out, shaped and
    typed as q.  The caller has validated the arguments.  Raises if the
    launch is refused."""
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
