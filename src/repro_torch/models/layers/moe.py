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

Drop-free routing (``cfg.moe_drop_free``, DeepSeek-V2-Lite) takes no
capacity and drops no row: the (token, expert) rows bound for the
experts this device holds (``cfg.moe_experts_held``, experts ``[0,
held)``: one device's share under expert parallelism; all by default)
are sorted by expert, and grouped GEMMs over the ragged segments
(:mod:`repro_torch.kernels.moe_gemm`) compute them, reading the
segments' ends on the device: the step makes no host synchronisation.
The buffers hold every routed row (no count reaches the host); the rows
bound for experts held elsewhere are dead: the products skip them, and
the layer masks them to 0 on the way in (their gradient) and out.  The
router still scores all ``moe_n_routed`` experts; what the experts held
elsewhere would add is left out: the layer runs on one device, without
its exchange, and refuses a model or expert-parallel axis.  The router's options: ``moe_norm_topk`` (off:
the top-k softmax probabilities as they are) and ``moe_seq_aux`` (the balance loss per sequence, averaged over the
sequences, as DeepSeek-V2's ``seq_aux``).  Each drop-free call adds to
device counters (:func:`counters`): calls, rows computed, and the most
loaded held expert's rows over the mean.

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

from repro_torch.kernels.moe_gemm import ops as moe_gemm
from repro_torch.tracing import forward_span
from .common import init_mlp, mlp, normal_init

Params = Dict[str, Any]


def init_moe(cfg, gen: torch.Generator, lead: Tuple = ()) -> Params:
    d = cfg.d_model
    e = cfg.moe_n_experts_local
    f = cfg.moe_d_ff
    dt = cfg.param_dtype
    p = {
        "router": normal_init(gen, (*lead, d, cfg.moe_n_routed_padded),
                              torch.float32, d ** -0.5),
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


def _route(cfg, p: Params, x2d: torch.Tensor, ctx=None, sum_aux: bool = True,
           seqs: int = 1
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, d) -> (top-k probs (T,k), top-k ids (T,k), aux loss).
    With `ctx` the tokens are this rank's batch shard, and (`sum_aux`)
    the aux loss's statistics are summed over the batch axes.  `seqs`:
    the sequences the T tokens are (for ``moe_seq_aux``)."""
    e_pad, e = cfg.moe_n_routed_padded, cfg.moe_n_routed
    logits = x2d.float() @ p["router"]
    if e_pad != e:
        logits = logits.masked_fill(
            torch.arange(e_pad, device=x2d.device) >= e, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _topk_iterative(probs, cfg.moe_top_k)
    if cfg.moe_norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    if cfg.moe_seq_aux:
        aux = _seq_aux(cfg, probs, top_i, seqs)
        if ctx is not None and ctx.n_batch > 1 and sum_aux:
            aux = ctx.batch_sum(aux, grad_sum=True) / ctx.n_batch
        return top_p.to(x2d.dtype), top_i, aux
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


def _seq_aux(cfg, probs: torch.Tensor, top_i: torch.Tensor, seqs: int
             ) -> torch.Tensor:
    """DeepSeek-V2's expert-level balance loss with ``seq_aux``: per
    sequence, E times the sum over experts of the mean router probability
    and the share of the sequence's top-k picks (counts over S k), then
    the mean over the sequences."""
    e_pad, e = cfg.moe_n_routed_padded, cfg.moe_n_routed
    T, k = top_i.shape
    me = probs.reshape(seqs, T // seqs, e_pad).mean(dim=1)[:, :e]
    ce = torch.zeros((seqs, e_pad), device=probs.device).scatter_add_(
        1, top_i.reshape(seqs, -1).long(),
        torch.ones((seqs, T // seqs * k), device=probs.device))[:, :e]
    ce = ce / (T // seqs * k)
    return e * (me * ce).sum(dim=-1).mean()


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
    if cfg.moe_drop_free:
        return _moe_drop_free(cfg, p, x, ctx, ep_axis, sum_aux)
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


# ------------------------------------------------------------ drop-free
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def counters() -> Optional[Dict[str, float]]:
    """The drop-free layer's counters, summed over devices and read once
    (a host sync): ``calls``, ``rows`` (rows computed, summed over the
    calls) and ``imbalance`` (the most loaded held expert's rows over the
    mean, summed over the calls); None before any call."""
    if not _COUNTERS:
        return None
    calls, rows, imbalance = sum(c.cpu() for c in _COUNTERS.values()
                                 ).tolist()
    return {"calls": calls, "rows": rows, "imbalance": imbalance}


def reset_counters() -> None:
    for c in _COUNTERS.values():
        c.zero_()


def _count(counts: torch.Tensor) -> None:
    """Add one call's (held,) row counts to the device's counters, on
    the device (no sync)."""
    c = _COUNTERS.get(counts.device)
    if c is None:
        c = _COUNTERS[counts.device] = torch.zeros(3, device=counts.device,
                                                   dtype=torch.float64)
    f = counts.double()
    c.add_(torch.stack([torch.ones_like(f[0]), f.sum(),
                        f.max() / f.mean().clamp_min(1e-30)]))


def dropfree_plan(top_i: torch.Tensor, top_p: torch.Tensor, held: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The rows of a drop-free layer, sorted by expert: (token of each
    row (T k,) int64, its weight (T k,), the held experts' segment ends
    (held,) int32, their row counts (held,)).  Rows bound for experts
    outside ``[0, held)`` sort last, past the last end: dead, weight 0.
    Stable: a token keeps its order inside its expert."""
    T, k = top_i.shape
    flat_e = top_i.reshape(-1).long()
    key = torch.where(flat_e < held, flat_e, held)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(held + 1, dtype=torch.long,
                         device=top_i.device).scatter_add_(
        0, key, torch.ones_like(key))[:held]
    return (order // k,
            torch.where(key[order] < held, top_p.reshape(-1)[order], 0),
            counts.cumsum(0).to(torch.int32), counts)


def held_experts(p: Params, x2d: torch.Tensor, tok: torch.Tensor,
                 w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """(T, d): each token's sum of w E_e(x) over its live rows, the rows
    as :func:`dropfree_plan` makes them.  The grouped products leave a
    dead row unspecified, in their output and in their input's
    gradient: both are masked to 0 before they reach a token."""
    live = (torch.arange(tok.shape[0], device=tok.device)
            < ends[-1])[:, None]
    with forward_span("model.moe.experts"):
        xs = x2d.index_select(0, tok)
        xs = torch.where(live, xs, xs.detach())  # a dead row's grad: 0
        y = moe_gemm.swiglu(xs, ends, p["w_gate"], p["w_up"], p["w_down"])
    with forward_span("model.moe.combine"):
        return torch.zeros_like(x2d).index_add_(
            0, tok, torch.where(live, y, 0) * w[:, None])


def _moe_drop_free(cfg, p: Params, x: torch.Tensor, ctx, ep_axis, sum_aux
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = sum over the token's top-k experts that are held of p_i E_i(x),
    plus the shared experts; every such row computed (module
    docstring)."""
    experts, shared_tp = tp_groups(cfg, ctx, ep_axis)
    if ctx is not None and (ctx.tp is not None or experts is not None
                            and experts.size > 1):
        raise NotImplementedError(
            "drop-free routing computes this device's held experts whole, "
            "without an exchange: it runs on no model or expert-parallel "
            "axis of more than one rank")
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    with forward_span("model.moe.route"):
        top_p, top_i, aux = _route(cfg, p, x2d, ctx, sum_aux, seqs=B)
    with forward_span("model.moe.dispatch"):
        row, w, ends, counts = dropfree_plan(top_i, top_p,
                                             cfg.moe_n_experts_local)
        _count(counts)
    out = held_experts(p, x2d, row, w, ends).reshape(B, S, d)
    if "shared" in p:
        out = out + mlp(p["shared"], x, shared_tp)
    return out, aux.float()
