"""The drop-free MoE layer's routed experts: grouped matrix products over
the held experts' row segments.

Replaces no TPU kernel: the JAX package pads every expert to a capacity
and runs XLA's batched einsums over the (groups, experts, capacity, d)
buffer, dropping the rows past it.  A drop-free layer with such a buffer
would pad every expert to every token (about eight times the rows it
computes at 64 experts and top-6), so the port sorts the rows by expert
(``models.layers.moe.dropfree_plan``) and multiplies the ragged segments
as they are.

On the card each product is PyTorch's grouped GEMM
(``torch._grouped_mm``, bf16 operands, f32 accumulation): one launch
over every segment, whose ends it reads on the device, so the step makes
no host synchronisation; autograd takes its backward (a grouped product
for the rows' gradient, one over each segment's rows for the weights').
It neither computes nor writes a row past the last end: such a dead
row's values are unspecified, and the layer masks them out before any
sum (``moe.held_experts``).  For CPU tensors the plain version
(:mod:`.ref`) takes its place.  ``CALLS`` counts the grouped products
called on the card (forward and remat's recompute; autograd's backward
products are its own), and nothing else.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from . import ref

CALLS = 0
_count_lock = threading.Lock()


def gmm(a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor
        ) -> torch.Tensor:
    """a (R, K) rows sorted by segment, b (held, K, N), ends (held,)
    int32 on a's device -> (R, N): row r of held expert e's segment is
    a[r] b[e]; a dead row is unspecified."""
    if a.device.type == "cpu":
        return ref.gmm(a, b, ends)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"moe_gemm.gmm: bf16 operands on the card; got "
                        f"{a.dtype} and {b.dtype}")
    global CALLS
    with _count_lock:
        CALLS += 1
    return torch._grouped_mm(a, b, offs=ends)


def swiglu(xs: torch.Tensor, ends: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """xs (R, d) -> (R, d): each live row's (silu(x W_gate[e]) * x W_up[e])
    W_down[e]; w_gate, w_up (held, d, f), w_down (held, f, d).  SiLU
    computes in f32 and rounds once, as ``common.mlp``'s."""
    g, u = gmm(xs, w_gate, ends), gmm(xs, w_up, ends)
    return gmm(F.silu(g) * u, w_down, ends)
