"""Serving steps: prefill (prompt -> cache) and decode (one token, KV cache).

The port of ``repro.serve.step``: the entry points a serving engine
calls.  Both run under ``torch.inference_mode()``.  ``decode`` updates
the caches in place (the reference donates them) and returns them.

Both steps understand bucketed (left-padded) prompts: the prefill batch
may carry ``positions`` (pad-relative RoPE positions) and ``pad_mask``
(False on pad key slots), and the decode step takes an optional ``start``
vector marking the first real cache slot per row. See
``transformer.prefill``.

Both take DTensor params too (``Plan(serving=True)``'s weight-stationary
layout, see ``transformer``): the caches and logits are then DTensors in
``Plan.cache_specs``'s and ``Plan.logits_spec``'s layouts, and a greedy
token is each vocab shard's max and first index combined over the shards
(:func:`greedy`), never a gathered row of logits.  DTensor's
``from_local``, ``redistribute`` and the functional collectives behave
under ``inference_mode`` (tested on gloo ranks), so the sharded steps
keep it.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.parallel import Group


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1) int32 argmax of the last position's logits (B, S, V).  On a
    DTensor whose vocab is split over mesh axes, each shard's max and
    first index, then over each such axis the max and the lowest index
    that reaches it: ties go to the lowest index, as ``jnp.argmax``'s
    do.  The tokens keep the logits' row split."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    mesh = logits.device_mesh
    local = logits.to_local()[:, -1, :]
    idx = torch.argmax(local, dim=-1)
    val = local.gather(-1, idx[:, None])[:, 0]
    pl = list(logits.placements)
    for i, p in enumerate(pl):
        if p.is_shard() and p.dim == logits.ndim - 1:
            g = Group(mesh, mesh.mesh_dim_names[i])
            idx = idx + g.rank * local.shape[-1]
            best = g.max(val)
            idx = g.min(torch.where(val == best, idx,
                                    torch.iinfo(idx.dtype).max))
            pl[i] = Replicate()
    return DTensor.from_local(idx.to(torch.int32)[:, None], mesh, pl,
                              run_check=False)


def make_prefill_step(cfg: ModelConfig, *, moe_groups: int = 1,
                      moe_ep_axis=None):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return transformer.prefill(cfg, params, batch,
                                       moe_groups=moe_groups,
                                       moe_ep_axis=moe_ep_axis,
                                       positions=batch.get("positions"),
                                       pad_mask=batch.get("pad_mask"))
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, sample: bool = False,
                     moe_groups: int = 1, moe_ep_axis=None):
    def decode_step(params, caches, tokens, pos, start=None):
        with torch.inference_mode():
            caches, logits = transformer.decode_step(
                cfg, params, caches, tokens, pos, moe_groups=moe_groups,
                moe_ep_axis=moe_ep_axis, start=start)
            if sample:
                return caches, logits, greedy(logits)
            return caches, logits
    return decode_step
