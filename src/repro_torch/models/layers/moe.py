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

Two combines, as in the reference: the GSPMD one (every rank runs every
expert on its groups) and the expert-parallel one
(:func:`_combine_ep`, the reference's ``_combine_ep_shardmap``), taken
when a sharded step's mesh has ``ep_axis`` and that axis divides the
experts.  On a sharded step (``ctx``, see
:mod:`repro_torch.sharding.parallel`) each rank routes its own batch
shard: its groups are its share of ``groups``, and the load-balance
loss's expert means and counts are summed over the batch axes, so the
aux loss is the reference's global one.
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


def _route(cfg, p: Params, x2d: torch.Tensor, ctx=None, sum_aux: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, d) -> (top-k probs (T,k), top-k ids (T,k), aux loss).
    With `ctx` the tokens are this rank's batch shard, and (`sum_aux`)
    the aux loss's statistics are summed over the batch axes."""
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
    if ctx is not None and ctx.n_batch > 1 and sum_aux:
        me = ctx.batch_sum(me, grad_sum=True) / ctx.n_batch
        ce = ctx.batch_sum(ce.detach())
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


def tp_groups(cfg, ctx, ep_axis: Optional[str]):
    """(experts' group, shared experts' group) of a sharded step (`ctx`),
    None where every rank runs all of it: the expert-parallel group when
    `ep_axis` is in the mesh and divides the experts, and the model group
    where it divides the shared experts' width.  The one rule for the
    layer's compute and its weights' uses (``transformer._block_groups``)."""
    if ctx is None:
        return None, None
    shared = (ctx.tp_for(cfg.moe_n_shared * cfg.moe_d_ff)
              if cfg.moe_n_shared else None)
    return ctx.ep_group(ep_axis, cfg.moe_n_routed_padded), shared


def moe_forward(cfg, p: Params, x: torch.Tensor, *, groups: int = 1,
                ep_axis: Optional[str] = None, ctx=None, sum_aux: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss). See module docstring.  Without
    `ctx` (one device, no mesh) ``ep_axis`` names no mesh axis and the
    GSPMD combine runs, as in the reference without a mesh.  A decode
    step, which drops the aux loss, passes ``sum_aux=False``: the batch
    shards' statistics are then not summed (no collective over the
    batch axes)."""
    B, S, d = x.shape
    T = B * S
    k = cfg.moe_top_k
    e = cfg.moe_n_routed_padded
    ep, shared_tp = tp_groups(cfg, ctx, ep_axis)
    n = 1 if ctx is None else ctx.n_batch
    if (T * n) % groups != 0:
        groups = 1
    if groups % n:
        raise NotImplementedError(
            f"moe_forward: {groups} groups do not split over the {n} batch "
            "shards")
    groups //= n                                       # this rank's groups
    tg = T // groups                                   # tokens per group
    cap = int(-(-cfg.moe_capacity_factor * tg * k // e))
    cap = max(8, ((cap + 7) // 8) * 8)

    x2d = x.reshape(T, d)
    top_p, top_i, aux = _route(cfg, p, x2d, ctx, sum_aux)
    xg = x2d.reshape(groups, tg, d)
    dest, keep, sorted_tok, wsort = _dispatch_plan(
        cfg, top_p, top_i, groups, tg, cap, e)
    if ep is None:
        combined = _combine_gspmd(cfg, p, xg, dest, keep, sorted_tok, wsort,
                                  groups, cap, e, d)
    else:
        combined = _combine_ep(cfg, p, xg, dest, keep, sorted_tok, wsort,
                               groups, cap, e, d, ep)
    out = combined.reshape(B, S, d)
    if "shared" in p:
        out = out + mlp(p["shared"], x, shared_tp)
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


def _combine_ep(cfg, p, xg, dest, keep, sorted_tok, wsort, groups, cap, e,
                d, ep):
    """The expert-parallel combine (the reference's
    ``_combine_ep_shardmap``): this rank holds experts
    ``[rank * e_local, (rank + 1) * e_local)`` of the ``ep`` group,
    scatters only the rows bound for them, runs them, and the (g, tg, d)
    partial combines are summed over the group.  The routing before it
    runs alike on every rank of the group, so the tokens and weights
    enter through ``copy_in`` (their gradients summed over the experts'
    ranks) and the sum leaves through ``reduce_out`` (the gradient of a
    replicated output passes to every rank's partial unchanged)."""
    e_local = e // ep.size
    xg, wsort = ep.copy_in(xg), ep.copy_in(wsort)
    local_dst = dest - ep.rank * e_local * cap
    mine = keep & (local_dst >= 0) & (local_dst < e_local * cap)
    dst = torch.where(mine, local_dst, e_local * cap)   # spare row
    gi = torch.arange(groups, device=xg.device)[:, None]
    buf = torch.zeros((groups, e_local * cap + 1, d), dtype=xg.dtype,
                      device=xg.device)
    buf[gi, dst] = xg[gi, sorted_tok]
    out_buf = _expert_block(
        p, buf[:, :e_local * cap].reshape(groups, e_local, cap, d),
        xg.dtype).reshape(groups, e_local * cap, d)
    out_buf = F.pad(out_buf, (0, 0, 0, 1))    # the spare row reads zeros
    gathered = torch.where(mine[..., None], out_buf[gi, dst], 0.0)
    partial = torch.zeros_like(xg).index_put_(
        (gi.expand_as(sorted_tok), sorted_tok), gathered * wsort[..., None],
        accumulate=True)
    return ep.reduce_out(partial)
