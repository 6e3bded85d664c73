"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

The port of ``repro.models.layers.moe`` on one device:
  * Router over the *logical* expert count; experts padded to a multiple
    of 16 (padding experts masked to -1e30 in the router), top-k by k
    rounds of argmax + mask (the first maximum wins, as in the reference).
  * Dispatch = per-group stable argsort by expert id -> position-in-expert
    via segment offsets -> scatter into an (E, C, d) buffer (capacity
    drop) -> batched per-expert SwiGLU -> weighted combine-scatter back.
    The buffer carries one spare row at ``e * cap``: dropped rows are
    written there and read back as zeros, where the reference's
    out-of-bounds scatter drops them and its gather fills zeros.
  * Shared experts are one wide SwiGLU.

Only the reference's GSPMD combine is ported.  Its expert-parallel
``shard_map`` path (``ep_axis``) waits for the port's sharding layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import init_mlp, mlp, normal_init

Params = Dict[str, Any]


def init_moe(cfg, gen: torch.Generator, lead: Tuple = ()) -> Params:
    d = cfg.d_model
    e = cfg.moe_n_routed_padded
    f = cfg.moe_d_ff
    dt = cfg.param_dtype
    p = {
        "router": normal_init(gen, (*lead, d, e), torch.float32, d ** -0.5),
        "w_gate": normal_init(gen, (*lead, e, d, f), dt, d ** -0.5),
        "w_up": normal_init(gen, (*lead, e, d, f), dt, d ** -0.5),
        "w_down": normal_init(gen, (*lead, e, f, d), dt, f ** -0.5),
    }
    if cfg.moe_n_shared:
        p["shared"] = init_mlp(cfg, gen, cfg.moe_n_shared * cfg.moe_d_ff,
                               lead)
    return p


def _topk_iterative(probs: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) -> (top-k values, int32 indices), k rounds of argmax+mask."""
    vals, idxs = [], []
    cur = probs
    eye = torch.arange(probs.shape[-1], device=probs.device)[None, :]
    for _ in range(k):
        i = torch.argmax(cur, dim=-1)
        vals.append(cur.gather(-1, i[:, None])[:, 0])
        idxs.append(i.to(torch.int32))
        cur = cur.masked_fill(eye == i[:, None], -torch.inf)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def _route(cfg, p: Params, x2d: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, d) -> (top-k probs (T,k), top-k ids (T,k), aux loss)."""
    e_pad, e = cfg.moe_n_routed_padded, cfg.moe_n_routed
    logits = x2d.float() @ p["router"]
    if e_pad != e:
        logits = logits.masked_fill(
            torch.arange(e_pad, device=x2d.device) >= e, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _topk_iterative(probs, cfg.moe_top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance auxiliary loss over logical experts.
    me = probs.mean(dim=0)[:e]
    ce = torch.zeros(e_pad, device=x2d.device).index_add_(
        0, top_i.reshape(-1).long(),
        torch.ones(top_i.numel(), device=x2d.device))[:e]
    ce = ce / ce.sum().clamp_min(1.0)
    aux = e * torch.sum(me * ce)
    return top_p.to(x2d.dtype), top_i, aux


def _dispatch_plan(cfg, top_p, top_i, groups: int, tg: int, cap: int, e: int):
    """Sort-based dispatch metadata, all group-local ops.  The sort is
    stable (as ``jnp.argsort``), so a token keeps its order inside its
    expert and the capacity drop falls on the same rows."""
    k = cfg.moe_top_k
    flat_e = top_i.reshape(groups, tg * k).long()
    flat_w = top_p.reshape(groups, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # per-group sort
    sorted_e = flat_e.gather(-1, order)
    sorted_tok = order // k
    counts = torch.zeros((groups, e), dtype=torch.long,
                         device=flat_e.device).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))               # (g, e)
    seg_start = counts.cumsum(dim=-1) - counts
    pos_in_e = (torch.arange(tg * k, device=flat_e.device)[None, :]
                - seg_start.gather(-1, sorted_e))
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)  # spare row
    wsort = flat_w.gather(-1, order)
    return dest, keep, sorted_tok, wsort


def _expert_block(p, buf, x_dtype):
    """Per-expert SwiGLU on packed (g, e, cap, d) buffers."""
    g_ = torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
    u_ = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    h = F.silu(g_.float()).to(x_dtype) * u_
    return torch.einsum("gecf,efd->gecd", h, p["w_down"])


def moe_forward(cfg, p: Params, x: torch.Tensor, *, groups: int = 1,
                ep_axis: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). See module docstring."""
    if ep_axis is not None:
        raise NotImplementedError(
            "moe_forward: the expert-parallel path (ep_axis) is not ported; "
            "it waits for the sharding layer (ROADMAP Queue 1, item 16)")
    B, S, d = x.shape
    T = B * S
    k = cfg.moe_top_k
    e = cfg.moe_n_routed_padded
    if T % groups != 0:
        groups = 1
    tg = T // groups                                   # tokens per group
    cap = int(-(-cfg.moe_capacity_factor * tg * k // e))
    cap = max(8, ((cap + 7) // 8) * 8)

    x2d = x.reshape(T, d)
    top_p, top_i, aux = _route(cfg, p, x2d)
    xg = x2d.reshape(groups, tg, d)
    dest, keep, sorted_tok, wsort = _dispatch_plan(
        cfg, top_p, top_i, groups, tg, cap, e)
    combined = _combine_gspmd(cfg, p, xg, dest, keep, sorted_tok, wsort,
                              groups, cap, e, d)
    out = combined.reshape(B, S, d)
    if "shared" in p:
        out = out + mlp(p["shared"], x)
    return out, aux.float()


def _combine_gspmd(cfg, p, xg, dest, keep, sorted_tok, wsort,
                   groups, cap, e, d):
    """Scatter into the expert buffer, run the experts, gather and
    combine (the reference's one-device path)."""
    gi = torch.arange(groups, device=xg.device)[:, None]
    buf = torch.zeros((groups, e * cap + 1, d), dtype=xg.dtype,
                      device=xg.device)
    buf[gi, dest] = xg[gi, sorted_tok]        # dropped rows -> spare row
    out_buf = _expert_block(p, buf[:, :e * cap].reshape(groups, e, cap, d),
                            xg.dtype).reshape(groups, e * cap, d)
    out_buf = F.pad(out_buf, (0, 0, 0, 1))    # the spare row reads zeros
    gathered = torch.where(keep[..., None], out_buf[gi, dest], 0.0)
    return torch.zeros_like(xg).index_put_(
        (gi.expand_as(sorted_tok), sorted_tok), gathered * wsort[..., None],
        accumulate=True)
