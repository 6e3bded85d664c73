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
nothing to move here.  Under sequence parallelism (an act_spec that
splits the sequence over "model") it is each model rank's chunk of the
sequence between sublayers instead (:class:`SeqGroup`): all-gathers and
reduce-scatters on the sequence take the place of ``copy_in`` and
``reduce_out``.  At one device every placement is ``Replicate``,
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
                     # (or all of it on a rank-specific part of the
                     # data: a norm on its sequence chunk)


def _sum_out(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over a group into a fresh tensor (a functional collective):
    the ``save_tp_out`` remat policy saves this op's output
    (:data:`TP_OUT_OPS`), which it could not do for an in-place sum."""
    y = torch.ops._c10d_functional.all_reduce(x, "sum", group.group_name)
    return torch.ops._c10d_functional.wait_tensor(y)


def _seq_all_gather(x: torch.Tensor, g: "Group") -> torch.Tensor:
    """The group's sequence chunks (dim 1) gathered, rank order."""
    y = torch.ops._c10d_functional.all_gather_into_tensor(
        x.transpose(0, 1).contiguous(), g.size, g.group.group_name)
    return torch.ops._c10d_functional.wait_tensor(y).transpose(0, 1)


def _seq_reduce_scatter(x: torch.Tensor, g: "Group") -> torch.Tensor:
    """This rank's sequence chunk (dim 1) of the sum over the group."""
    y = torch.ops._c10d_functional.reduce_scatter_tensor(
        x.transpose(0, 1).contiguous(), "sum", g.size, g.group.group_name)
    return torch.ops._c10d_functional.wait_tensor(y).transpose(0, 1)


def _seq_chunk(x: torch.Tensor, g: "Group") -> torch.Tensor:
    n = x.shape[1] // g.size
    return x[:, g.rank * n:(g.rank + 1) * n]


# the ops whose outputs are a sublayer's TP output: what the reference
# names "tp_out" and its ``save_tp_out`` remat policy keeps (the sum that
# ends a sharded sublayer, or its reduce-scatter under sequence
# parallelism)
TP_OUT_OPS = (torch.ops._c10d_functional.all_reduce.default,
              torch.ops._c10d_functional.reduce_scatter_tensor.default)


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the gradient summed too (``grad_sum``) or passed
    through (the forward's output feeds replicated work: a sublayer's TP
    output, which :func:`_sum_out` computes)."""

    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        if not grad_sum:
            return _sum_out(x, group)
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


class _SeqGather(torch.autograd.Function):
    """The sequence gathered from its chunks; the gradient
    reduce-scattered (``grad_sum``: every rank's is a partial sum) or
    sliced (every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, g, grad_sum):
        ctx.g, ctx.grad_sum = g, grad_sum
        return _seq_all_gather(x, g)

    @staticmethod
    def backward(ctx, grad):
        return (_seq_reduce_scatter(grad, ctx.g) if ctx.grad_sum
                else _seq_chunk(grad, ctx.g)), None, None


class _SeqScatter(torch.autograd.Function):
    """This rank's sequence chunk of a sum of partials (``summed``: a
    reduce-scatter) or of a tensor every rank holds whole (a slice); the
    gradient gathered."""

    @staticmethod
    def forward(ctx, x, g, summed):
        ctx.g = g
        return (_seq_reduce_scatter(x, g) if summed
                else _seq_chunk(x, g).clone())

    @staticmethod
    def backward(ctx, grad):
        return _seq_all_gather(grad.contiguous(), ctx.g), None, None


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


class SeqGroup:
    """The model axis under sequence parallelism (Megatron-style): the
    residual stream between sublayers is each rank's chunk of the
    sequence.  A tensor-parallel sublayer takes this in place of its
    :class:`Group`: :meth:`copy_in` gathers the sequence (its gradient
    reduce-scattered) and :meth:`reduce_out` reduce-scatters the
    shards' partial sums (its gradient gathered); the sums inside a
    sublayer (:meth:`all_reduce`, :meth:`max`) are the group's own.  A
    sublayer that runs replicated gets :meth:`gather`'s whole sequence
    and leaves through :meth:`scatter`, this rank's chunk."""

    def __init__(self, group: Group):
        self.base = group
        self.name, self.size, self.rank = group.name, group.size, group.rank
        self.group = group.group

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _SeqGather.apply(x, self.base, True)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _SeqScatter.apply(x, self.base, True)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.all_reduce(x)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.max(x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _SeqGather.apply(x, self.base, False)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % self.size:
            raise ValueError(
                f"sequence parallelism: a sequence of {x.shape[1]} does "
                f"not split over the {self.size} ranks of {self.name!r}")
        return _SeqScatter.apply(x, self.base, False)


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
    batch, the tensor-parallel axis, and (``sp``) whether the residual
    stream is split on the sequence over it (``seq``, a
    :class:`SeqGroup`; None without sequence parallelism or without a
    model axis to split over)."""

    tp_axis = "model"        # the axis the planner's TP roles use

    def __init__(self, mesh, batch_axes: Sequence[str], sp: bool = False):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.batch_axes = tuple(batch_axes)
        self.batch = [Group(mesh, a) for a in self.batch_axes]
        self.n_batch = 1
        for g in self.batch:
            self.n_batch *= g.size
        # a batch split over the model axis too (pure data parallelism)
        # runs no TP: each rank's rows need the whole layer
        tp = (Group(mesh, self.tp_axis) if self.tp_axis in self.names
              and self.tp_axis not in self.batch_axes else None)
        self.tp = tp if tp is not None and tp.size > 1 else None
        self.seq = SeqGroup(self.tp) if sp and self.tp is not None else None

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
        if (ep_axis is None or ep_axis not in self.names
                or ep_axis in self.batch_axes):
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
    "data"); an act_spec that splits the sequence over the model axis
    (``Plan.act_spec(sp=True)``) turns on sequence parallelism."""
    leaf = next((t for t in tree_leaves(params) if isinstance(t, DTensor)),
                None)
    if leaf is None:
        return None
    mesh = leaf.device_mesh
    plan = Plan.for_mesh(mesh)
    sp = False
    if act_spec is not None:
        sp = seq_axis(act_spec) == Ctx.tp_axis
        rest = tuple(act_spec)[2:] if sp else tuple(act_spec)[1:]
        if any(e is not None for e in rest):
            raise NotImplementedError(
                f"act_spec {act_spec}: only the batch dim, and the "
                f"sequence over {Ctx.tp_axis!r}, are split here")
        first = tuple(act_spec)[0]
        if sp and first is not None and Ctx.tp_axis in (
                (first,) if isinstance(first, str) else tuple(first)):
            raise NotImplementedError(
                f"act_spec {act_spec}: the batch and the sequence both "
                f"split over {Ctx.tp_axis!r}")
        axes = (() if first is None else
                (first,) if isinstance(first, str) else tuple(first))
        plan = dataclasses.replace(plan, dp_axes=axes)
    size = next(iter(batch.values())).shape[0]
    return Ctx(mesh, [a for a in plan._dp(size) or ()
                      if plan.mesh_axes[a] > 1], sp=sp)


def seq_axis(spec) -> Optional[str]:
    """The axis a (B, S, D) activation spec splits the sequence over."""
    entries = tuple(spec) if spec is not None else ()
    return entries[1] if len(entries) > 1 else None
