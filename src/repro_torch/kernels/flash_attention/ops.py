"""Public wrapper for the flash-attention kernel (autotuned block sizes).

For a CUDA tensor :func:`attention` launches the hand-written kernel
(:mod:`.flash_attention`: ``mma.sync`` tensor cores, 3xTF32 in f32 and
bf16 in bf16) or raises — it never falls back.  For a CPU tensor it runs
the plain version (:mod:`.ref`), which is what the CPU tests reach.
``LAUNCHES`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels import autotune
from . import flash_attention as kernel
from . import ref

LAUNCHES = 0
_count_lock = threading.Lock()


def resolve_blocks(S_q: int, S_k: int, hd: int, dtype: torch.dtype, device,
                   bq: Optional[int], bk: Optional[int]) -> Tuple[int, int]:
    """Block sizes for attention: explicit args win, else the autotune
    registry, else :data:`autotune.DEFAULTS`.  A registry entry the
    kernel is not built for (say, one tuned for an older kernel) counts
    as a miss.  Not snapped to divisors: the kernel masks the ragged edge
    of S itself."""
    if bq is None or bk is None:
        tuned = autotune.lookup(
            "flash_attention", {"S_q": S_q, "S_k": S_k, "hd": hd}, dtype,
            device)
        if tuned is None or not kernel.accepts(
                tuned.get("bq", 0), tuned.get("bk", 0), hd, dtype.itemsize):
            tuned = autotune.DEFAULTS["flash_attention"]
        bq = bq if bq is not None else tuned["bq"]
        bk = bk if bk is not None else tuned["bk"]
    return bq, bk


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              bq: Optional[int] = None,
              bk: Optional[int] = None) -> torch.Tensor:
    """q: (B, S_q, H, hd), k, v: (B, S_k, H, hd) -> (B, S_q, H, hd) in
    q's dtype (f32 or bf16).  GQA callers repeat KV first."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or (k.shape[0], k.shape[2], k.shape[3]) != (
                q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(f"attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         "(B, S_q, H, hd), (B, S_k, H, hd) twice")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"attention: inputs on {t.device} and "
                             f"{q.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise TypeError("attention: inputs must share one dtype, f32 "
                            f"or bf16; got {t.dtype} and {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attention: inputs must be contiguous and "
                             "16-byte aligned")
    B, S_q, H, hd = q.shape
    S_k = k.shape[1]
    if hd not in kernel.HEAD_DIMS:
        raise ValueError(f"attention: head dim {hd} not in "
                         f"{kernel.HEAD_DIMS}, the dims the kernel is "
                         "built for")
    if min(B, H, S_q, S_k) < 1 or B * H > 65535 \
            or max(S_q, S_k, window) >= 2**31 or window < 0:
        raise ValueError(f"attention: shape {tuple(q.shape)} / "
                         f"{tuple(k.shape)} or window {window} out of range")
    bq, bk = resolve_blocks(S_q, S_k, hd, q.dtype, q.device, bq, bk)
    if not kernel.accepts(bq, bk, hd, q.element_size()):
        raise ValueError(f"attention: bq={bq}, bk={bk} outside the "
                         f"kernel's limits (bq a multiple of "
                         f"{kernel.WARP_ROWS} up to {kernel.MAX_BQ}, bk in "
                         f"{kernel.BK_BUILT}, {kernel.SMEM_MAX} bytes of "
                         "shared memory)")
    out = torch.empty_like(q)
    kernel.attention_cuda(q, k, v, out, causal=causal, window=int(window),
                          bq=bq, bk=bk)
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return out
