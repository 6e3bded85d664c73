"""The plain PyTorch version of the flash-attention kernel (its oracle):
causal / windowed / bidirectional attention with the softmax in f32."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q,k,v: (B, S, H, hd) -> (B, S, H, hd) in q's dtype.  q and k are
    upcast to f32; the softmax weights are cast to v's dtype before the
    product with v."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (hd ** -0.5)
    S_q, S_k = q.shape[1], k.shape[1]
    qp = torch.arange(S_q, device=q.device)[:, None]
    kp = torch.arange(S_k, device=q.device)[None, :]
    ok = torch.ones((S_q, S_k), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window:
        ok &= (qp - kp) < window
    logits = torch.where(ok, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).to(q.dtype)
