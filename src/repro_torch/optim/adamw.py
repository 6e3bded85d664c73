"""AdamW with global-norm clipping.

The port of ``repro.optim.adamw``:
  * ``moment_dtype``: moments stored in f32 (default) or bf16; the math
    is always f32.
  * layer-by-layer update: a stacked (layer-axis) leaf larger than
    :data:`_SCANNED_UPDATE_BYTES` is updated one layer at a time, as the
    reference's ``lax.map`` does, so the f32 workspace is one layer.
  * in place: unlike the reference's pure function, :func:`update`
    writes the new values into the tensors of `params` and `opt` and
    returns those same trees.  A Hymba-1.5B state is ~16.6 GB; a second
    copy of it for the new values would double that.  The arithmetic is
    element for element the same.
  * ZeRO: on DTensor params, gradients and moments (one placement per
    leaf, ``sharding.Plan``'s) each rank updates its own shards in place;
    the global gradient norm, and with it the clip, is the norm of the
    full tensors: each leaf's local sum of squares, all-reduced over the
    mesh axes that shard it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.sharding.parallel import local
from repro_torch.tracing import span
from repro_torch.util import tree_leaves, tree_map

# leaves bigger than this (bytes) with a leading stack dim go layer by layer
_SCANNED_UPDATE_BYTES = 1 << 28  # 256 MB


class Hyper(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params: Any, moment_dtype: torch.dtype = torch.float32
         ) -> Dict[str, Any]:
    def zeros(p):
        if isinstance(p, DTensor):          # the param's placements
            return torch.zeros_like(p, dtype=moment_dtype)
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (leaves summed in
    the reference's order).  DTensor leaves count in full: their local
    sums are grouped by the mesh axes that shard them and all-reduced
    over those axes, once per group."""
    totals: Dict[tuple, torch.Tensor] = {}
    mesh = None
    for leaf in tree_leaves(tree):
        axes: tuple = ()
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            axes = tuple(i for i, p in enumerate(leaf.placements)
                         if isinstance(p, Shard))
            leaf = local(leaf)
        sq = torch.sum(torch.square(leaf.float()))
        totals[axes] = sq if axes not in totals else totals[axes] + sq
    total = None
    for axes, sq in totals.items():
        for i in axes:
            dist.all_reduce(sq, group=mesh.get_group(i))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def update(params: Any, grads: Any, opt: Dict[str, Any],
           step: torch.Tensor | int, hyper: Hyper,
           lr_scale: torch.Tensor | float = 1.0,
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, opt, metrics) with
    params and opt the trees passed in, holding the new values."""
    with span("train.optimizer"):
        gnorm = global_norm(grads)
        dev = gnorm.device
        scale = torch.clamp(hyper.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        t = _f32(step, dev) + 1.0
        bc1 = 1.0 - torch.pow(_f32(hyper.b1, dev), t)
        bc2 = 1.0 - torch.pow(_f32(hyper.b2, dev), t)
        lr = hyper.lr * _f32(lr_scale, dev)

        def elementwise(p, g, m, v):
            g32 = g.float() * scale
            m32 = hyper.b1 * m.float() + (1.0 - hyper.b1) * g32
            v32 = hyper.b2 * v.float() + (1.0 - hyper.b2) * torch.square(g32)
            mh = m32 / bc1
            vh = v32 / bc2
            delta = mh / (torch.sqrt(vh) + hyper.eps) \
                + hyper.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)

        def upd(p, g, m, v):
            p, g, m, v = (local(t) for t in (p, g, m, v))
            nbytes = p.numel() * p.element_size()
            if (p.ndim >= 3 and p.shape[0] > 1
                    and nbytes > _SCANNED_UPDATE_BYTES):
                for i in range(p.shape[0]):
                    elementwise(p[i], g[i], m[i], v[i])
            else:
                elementwise(p, g, m, v)

        tree_map(upd, params, grads, opt["m"], opt["v"])
        return params, opt, {"grad_norm": gnorm}
