"""The plain PyTorch version of the Mamba selective-scan kernel (its oracle).

Sequential recurrence, state in f32:
    h_t = a_t * h_{t-1} + b_t         (elementwise over (di, st))
    y_t = sum_st h_t * C_t            (readout over the state dim)

and its backward (the oracle of K3-bwd), the explicit reverse recurrence
with g_t = dL/dh_t:
    g_t = dy_t * C_t + a_{t+1} * g_{t+1},   a_S * g_S := dh_last
    da_t = g_t * h_{t-1},  db_t = g_t,  dh0 = a_0 * g_0,
    dC_t = sum_di dy_t * h_t

and the backward of the scan with its input tail (the oracle of the fused
backward): a_t = exp(dt_t * A), b_t = u_t * Bc_t, so that
    ddt_t = sum_st g_t * h_{t-1} * a_t * A,   du_t = sum_st g_t * Bc_t,
    dBc_t = sum_di g_t * u_t,                 dC_t = sum_di dy_t * h_t,
    dA = sum_{b,t} g_t * h_{t-1} * a_t * dt_t,  dh0 = a_0 * g_0
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def scan_backward(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                  h0: torch.Tensor, dy: Optional[torch.Tensor],
                  dh_last: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, ...]:
    """Cotangents dy (B,S,di) and dh_last (B,di,st) (None: zero) of
    :func:`scan`'s outputs -> (da, db, dC, dh0) in the inputs' dtypes;
    h and g are carried in f32."""
    B, S, di, st = a.shape
    h = h0.float()
    hs = []
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        hs.append(h)
    if dy is None:
        dy = torch.zeros((B, S, di), dtype=torch.float32, device=a.device)
    dy = dy.float()
    carry = (torch.zeros((B, di, st), dtype=torch.float32, device=a.device)
             if dh_last is None else dh_last.float())
    da = torch.empty((B, S, di, st), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    dC = torch.empty((B, S, st), dtype=torch.float32, device=a.device)
    for t in reversed(range(S)):
        g = dy[:, t, :, None] * C[:, t, None, :].float() + carry
        da[:, t] = g * (hs[t - 1] if t > 0 else h0.float())
        db[:, t] = g
        dC[:, t] = (dy[:, t, :, None] * hs[t]).sum(dim=1)
        carry = a[:, t].float() * g
    return (da.to(a.dtype), db.to(b.dtype), dC.to(C.dtype),
            carry.to(h0.dtype))


def ssm_backward(dt: torch.Tensor, A: torch.Tensor, u: torch.Tensor,
                 Bc: torch.Tensor, C: torch.Tensor, h0: torch.Tensor,
                 dy: Optional[torch.Tensor], dh_last: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, ...]:
    """dt, u (B,S,di), A (di,st), Bc, C (B,S,st), h0 (B,di,st), f32, and
    cotangents dy (B,S,di), dh_last (B,di,st) (None: zero) of
    :func:`scan` on a = exp(dt * A), b = u * Bc -> (ddt, dA, du, dBc, dC,
    dh0), f32; a sequential loop over t."""
    B, S, di = dt.shape
    st = A.shape[-1]
    f32 = dict(dtype=torch.float32, device=dt.device)
    A = A.float()
    h = h0.float()
    hs = []
    for t in range(S):
        a_t = torch.exp(dt[:, t, :, None].float() * A)
        h = a_t * h + u[:, t, :, None].float() * Bc[:, t, None, :].float()
        hs.append(h)
    dy = torch.zeros((B, S, di), **f32) if dy is None else dy.float()
    carry = (torch.zeros((B, di, st), **f32) if dh_last is None
             else dh_last.float())
    ddt = torch.empty((B, S, di), **f32)
    du = torch.empty_like(ddt)
    dBc = torch.empty((B, S, st), **f32)
    dC = torch.empty_like(dBc)
    dA = torch.zeros((di, st), **f32)
    for t in reversed(range(S)):
        dt_t = dt[:, t, :, None].float()
        a_t = torch.exp(dt_t * A)
        g = dy[:, t, :, None] * C[:, t, None, :].float() + carry
        q = g * (hs[t - 1] if t > 0 else h0.float()) * a_t
        ddt[:, t] = (q * A).sum(dim=-1)
        dA += (q * dt_t).sum(dim=0)
        du[:, t] = (g * Bc[:, t, None, :].float()).sum(dim=-1)
        dBc[:, t] = (g * u[:, t, :, None].float()).sum(dim=1)
        dC[:, t] = (dy[:, t, :, None] * hs[t]).sum(dim=1)
        carry = a_t * g
    return ddt, dA, du, dBc, dC, carry
