"""The sharded model step's runtime: DTensor params, local compute.

Parameters and optimizer state are DTensors placed by a
:class:`~repro_torch.sharding.planner.Plan`.  The model does not run on
DTensors op by op: each layer gathers what it needs and computes on
plain local tensors, with the few collectives written out
(:class:`Ctx`), as the reference's ``shard_map`` paths do:

  * **FSDP**: a layer's parameters are redistributed at the layer's use
    to Replicate over every axis but the tensor-parallel one (an
    all-gather over "data"); the gathered copy lives for that layer only
    (and is gathered again when remat recomputes the layer).
  * **TP**: a layer whose sharded dim divides the model axis keeps its
    weights sharded over "model" and runs Megatron-style on its shard
    (which layer does is decided in one place,
    ``models.transformer._block_groups``):
    :meth:`Group.copy_in` where a replicated activation enters the
    shard's work (identity forward, all-reduce of the gradient) and
    :meth:`Group.reduce_out` where the shards' partial sums leave it
    (all-reduce forward, identity backward).  A layer that does not
    divide gathers its weights over "model" too and runs replicated.
  * **Gradients** come back through the redistribution's backward: a
    local gradient is declared ``Partial`` over the axes that split the
    batch (and over "model" for a weight that each model rank uses only
    in part, ``"slice"``), so the backward reduce-scatters it into the
    parameter's own placements (or all-reduces it where the parameter is
    replicated).

The residual stream is every rank's batch shard (the act_spec layout:
batch over the dp axes that divide it, replicated over "model") from the
embedding to the loss, so the reference's per-layer ``_constrain`` has
nothing to move here.  At one device every placement is ``Replicate``,
no collective runs, and the layers compute what the plain path computes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding.planner import Plan, Spec, placements
from repro_torch.util import tree_leaves, tree_map

# how a layer uses a weight's model-axis shard
SHARD = "shard"      # computes on its own shard: gradient is the shard's
                     # (a weight the plan left whole over "model" is
                     # gathered and each rank uses its part: SLICE)
GATHER = "gather"    # gathers it and uses all of it on every model rank
SLICE = "slice"      # gathers it and uses a rank-specific part of it


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the gradient summed too (``grad_sum``) or passed
    through (the forward's output feeds replicated work)."""

    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class Group:
    """One mesh axis as a layer sees it: its size, this rank's index on
    it and the collectives over it (none when the size is 1)."""

    def __init__(self, mesh, name: str):
        self.name = name
        self.size = mesh.size(list(mesh.mesh_dim_names).index(name))
        self.rank = mesh.get_local_rank(name)
        self.group = mesh.get_group(name) if self.size > 1 else None

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _AllReduce.apply(x, self.group,
                                                         False)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum whose output feeds rank-specific work: the gradient is
        summed as well."""
        return x if self.size == 1 else _AllReduce.apply(x, self.group, True)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the group, outside autograd."""
        x = x.detach()
        if self.size > 1:
            x = x.clone()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x


def is_sharded(tree: Any) -> bool:
    return any(isinstance(t, DTensor) for t in tree_leaves(tree))


def distribute(t: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """A full tensor that every rank holds alike, as a DTensor placed by
    `spec`: each rank keeps its shard (a local split, no collective)."""
    rep = [Replicate()] * mesh.ndim
    d = DTensor.from_local(t, mesh, rep, run_check=False)
    pl = placements(spec, mesh)
    return d if pl == rep else d.redistribute(mesh, pl)


def distribute_tree(tree: Any, specs: Any, mesh, device=None) -> Any:
    """:func:`distribute` over a tree, leaf by leaf, each leaf first moved
    to `device` if one is given (so a rank holds one whole leaf there at
    a time); 0-d leaves (a train state's step) stay plain tensors."""
    def one(t, spec):
        if isinstance(t, DTensor):
            return t
        if device is not None:
            t = t.to(device)
        return t if t.ndim == 0 else distribute(t, mesh, spec)
    return tree_map(one, tree, specs)


def host_tree(tree: Any, keep: bool = True) -> Any:
    """Every leaf whole on the CPU, gathered leaf by leaf (a collective:
    every rank calls it).  A rank with `keep` false only joins the
    gathers, copies nothing to the host and gets None."""
    def one(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.to("cpu") if keep else None
    out = tree_map(one, tree)
    return out if keep else None


def local(t: torch.Tensor) -> torch.Tensor:
    """The local tensor of a DTensor (itself, not a copy), else `t`."""
    return t._local_tensor if isinstance(t, DTensor) else t


class Ctx:
    """The mesh as one step of the model sees it: which axes split the
    batch, and the tensor-parallel axis."""

    tp_axis = "model"        # the axis the planner's TP roles use

    def __init__(self, mesh, batch_axes: Sequence[str]):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.batch_axes = tuple(batch_axes)
        self.batch = [Group(mesh, a) for a in self.batch_axes]
        self.n_batch = 1
        for g in self.batch:
            self.n_batch *= g.size
        tp = (Group(mesh, self.tp_axis) if self.tp_axis in self.names
              else None)
        self.tp = tp if tp is not None and tp.size > 1 else None

    # ------------------------------------------------------- TP modes
    def tp_on(self, n: int) -> bool:
        """Whether a dim of size `n` runs sharded over the model axis."""
        return self.tp is not None and n % self.tp.size == 0

    def tp_for(self, n: int) -> Optional[Group]:
        return self.tp if self.tp_on(n) else None

    def ep_group(self, ep_axis: Optional[str], n_experts: int
                 ) -> Optional[Group]:
        """The expert-parallel group, when `ep_axis` is in the mesh and
        divides the experts (the reference's condition); else None."""
        if ep_axis is None or ep_axis not in self.names:
            return None
        g = Group(self.mesh, ep_axis)
        if n_experts % g.size:
            return None
        if g.size > 1 and ep_axis != self.tp_axis:
            raise NotImplementedError(
                f"experts are planned over {self.tp_axis!r}; ep_axis "
                f"{ep_axis!r} would need them resharded")
        return g

    # ------------------------------------------------------- params
    def localize(self, t: torch.Tensor, use: str = GATHER) -> torch.Tensor:
        """A layer's view of a (DTensor) weight: gathered over every axis
        but the model axis (and over that too unless `use` is SHARD), as
        a local tensor whose gradient flows back into the DTensor's own
        placements."""
        if not isinstance(t, DTensor):
            return t
        compute, grad = [], []
        for name, pl in zip(self.names, t.placements):
            model = name == self.tp_axis
            if model and use == SHARD and pl.is_shard():
                compute.append(pl)
                grad.append(pl)
                continue
            compute.append(Replicate())
            # a gathered weight's gradient is a partial sum over the ranks
            # that split the batch, and over "model" where each model rank
            # uses only its part of it
            part = name in self.batch_axes or (
                model and use != GATHER and self.tp is not None)
            grad.append(Partial() if part else Replicate())
        # redistributed even to its own placements: the backward brings
        # the gradient into the parameter's placements
        return t.redistribute(self.mesh, compute).to_local(
            grad_placements=grad)

    def localize_tree(self, tree: Any, uses: Any) -> Any:
        return tree_map(lambda t, u: self.localize(t, u), tree, uses)

    # ------------------------------------------------------- batch
    def batch_index(self) -> int:
        """This rank's batch shard (major axis first)."""
        idx = 0
        for g in self.batch:
            idx = idx * g.size + g.rank
        return idx

    def local_batch(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a batch leaf, the global batch that every
        rank holds alike (sliced, no collective)."""
        n = v.shape[0] // self.n_batch
        i = self.batch_index()
        return v[i * n:(i + 1) * n]

    def batch_sum(self, x: torch.Tensor, *, grad_sum: bool = False
                  ) -> torch.Tensor:
        """Sum of per-rank partials over the batch axes."""
        for g in self.batch:
            x = g.all_reduce(x) if grad_sum else g.reduce_out(x)
        return x

    def gather_out(self, y: torch.Tensor, *, shard_last: bool = False
                   ) -> torch.Tensor:
        """Every rank's output rows (and vocab shards: the layout of
        ``Plan.logits_spec``) gathered into the full tensor."""
        pl = [Shard(0) if n in self.batch_axes else
              (Shard(y.ndim - 1) if shard_last and n == self.tp_axis
               else Replicate()) for n in self.names]
        return DTensor.from_local(y, self.mesh, pl,
                                  run_check=False).full_tensor()


def context(params: Any, batch: Dict[str, Any], *, act_spec=None
            ) -> Optional[Ctx]:
    """The step's :class:`Ctx` when `params` are DTensors (else None, the
    one-device path).  The batch is split as ``Plan.batch_specs`` splits
    it, over the act_spec's batch axes (default: the plan's, "pod" and
    "data")."""
    leaf = next((t for t in tree_leaves(params) if isinstance(t, DTensor)),
                None)
    if leaf is None:
        return None
    mesh = leaf.device_mesh
    plan = Plan.for_mesh(mesh)
    if act_spec is not None:
        if any(e is not None for e in tuple(act_spec)[1:]):
            raise NotImplementedError(
                f"act_spec {act_spec}: only the batch dim is split here "
                "(no sequence parallelism)")
        first = tuple(act_spec)[0]
        axes = (() if first is None else
                (first,) if isinstance(first, str) else tuple(first))
        plan = dataclasses.replace(plan, dp_axes=axes)
    size = next(iter(batch.values())).shape[0]
    return Ctx(mesh, [a for a in plan._dp(size) or ()
                      if plan.mesh_axes[a] > 1])
