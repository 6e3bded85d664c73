"""Plain PyTorch version of the grouped matrix product over expert
segments: the CPU path of :mod:`.ops` and its oracle on the card.

Rows are (token, expert) pairs sorted by expert: rows ``[ends[e-1],
ends[e])`` belong to held expert e, and rows past ``ends[-1]`` (bound
for experts held elsewhere) are dead.  The card's grouped GEMM neither
computes nor writes a dead row, of its output or of its input's
gradient; this version fills them with NaN, so that a test on the CPU
shows any use the layer makes of them.  The loop over experts reads the
ends on the host, which the CPU path may.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def segments(ends: torch.Tensor) -> List[Tuple[int, int, int]]:
    """(expert, first row, end row) of each held expert."""
    out, lo = [], 0
    for e, hi in enumerate(ends.tolist()):
        out.append((e, lo, hi))
        lo = hi
    return out


def _product(a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor
             ) -> torch.Tensor:
    out = a.new_full((a.shape[0], b.shape[-1]), float("nan"))
    for e, lo, hi in segments(ends):
        out[lo:hi] = a[lo:hi] @ b[e]
    return out


class Gmm(torch.autograd.Function):
    """a (R, K), b (held, K, N) -> (R, N): row r of expert e's segment is
    a[r] b[e]; NaN in dead rows.  Its backward: the rows' gradient
    dy b[e]^T (NaN in dead rows) and b[e]'s a_e^T dy_e over the
    segment's rows alone (zero for an empty expert)."""

    @staticmethod
    def forward(ctx, a, b, ends):
        ctx.save_for_backward(a, b, ends)
        return _product(a, b, ends)

    @staticmethod
    def backward(ctx, dy):
        a, b, ends = ctx.saved_tensors
        db = torch.zeros_like(b)
        for e, lo, hi in segments(ends):
            db[e] = a[lo:hi].T @ dy[lo:hi]
        return _product(dy, b.transpose(1, 2), ends), db, None


def gmm(a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor
        ) -> torch.Tensor:
    return Gmm.apply(a, b, ends)
