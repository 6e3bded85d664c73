"""The plain PyTorch version of the Mamba selective-scan kernel (its oracle).

Sequential recurrence, state in f32:
    h_t = a_t * h_{t-1} + b_t         (elementwise over (di, st))
    y_t = sum_st h_t * C_t            (readout over the state dim)
"""
from __future__ import annotations

from typing import Tuple

import torch


def scan(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
         h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a,b: (B,S,di,st); C: (B,S,st); h0: (B,di,st) ->
    (y (B,S,di) f32, h_last (B,di,st) f32)."""
    h = h0.float()
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        ys.append((h * C[:, t, None, :].float()).sum(dim=-1))
    return torch.stack(ys, dim=1), h
