"""Int8 wire compression (tensor functions).

Error-feedback int8 quantization: each worker keeps a float32 residual of
what quantization dropped and folds it into the next round — the classic
EF-SGD construction that preserves convergence.  The DataPlane's
``replicate_to(compress="int8")`` ships its payload through
:func:`quantize_int8`.  :func:`compressed_psum` is the reference's int8
all-reduce with error feedback, over a ``torch.distributed`` process
group in place of a ``shard_map`` axis.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = x.abs().max().float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale.to(q.device)


def ef_quantize(x: torch.Tensor, residual: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantize: returns (q, scale, new_residual)."""
    target = x.float() + residual
    q, scale = quantize_int8(target)
    new_residual = target - dequantize_int8(q, scale)
    return q, scale, new_residual


def compressed_psum(x: torch.Tensor, residual: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce over the ranks of `group` (default: the world) with
    error feedback.  Returns (sum over ranks, new local residual).

    Two rounds, as in the reference: (1) an ``all_reduce(MAX)`` of the
    scalar amax agrees on one quantization scale, (2) the int8 payload is
    summed as int32 (no overflow for <= 2^23 ranks).  Whatever
    quantization dropped stays in the local residual for the next step.
    """
    import torch.distributed as dist
    target = x.float() + residual
    amax = target.abs().max().reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)   # scalar round
    scale = torch.clamp(amax[0], min=1e-12) / 127.0
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_residual = target - q.float() * scale
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)  # int8 payload
    out = q_sum.float() * scale
    return out.to(x.dtype), new_residual


def init_residuals(grads: Any) -> Any:
    """float32 zeros shaped like every tensor of a (nested dict/list/tuple)
    gradient tree."""
    if isinstance(grads, torch.Tensor):
        return torch.zeros(grads.shape, dtype=torch.float32,
                           device=grads.device)
    if isinstance(grads, dict):
        return {k: init_residuals(v) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(init_residuals(v) for v in grads)
    raise TypeError(f"init_residuals: unsupported leaf {type(grads)!r}")
