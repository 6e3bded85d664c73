"""Train step: grad-accumulation microbatching + AdamW.

The port of ``repro.train.step``.  The step is a function
(state, batch) -> (state, metrics).  Microbatches run in a Python loop
(the reference's ``lax.scan``), each one's gradients taken with
``torch.autograd.grad`` and accumulated in ``accum_dtype`` (f32), which
bounds stored activations to one microbatch plus the per-layer remat
checkpoints.  The AdamW step updates the state's tensors in place
(:mod:`repro_torch.optim.adamw`); ``step`` becomes a new tensor.

Sharded training is the same step on a DTensor state (placed by
``sharding.Plan``): ``loss_fn`` runs the sharded model, each
microbatch's gradients come back already reduce-scattered into the
parameters' placements, and are accumulated there shard by shard; the
AdamW step updates each rank's shards (ZeRO).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
# loaded here, not lazily: torch imports ``torch._dynamo`` at the first
# call of a function it marks ``_disable_dynamo`` (checkpoint, DTensor's
# redistribute), and that import leaves a frame cycle holding its
# caller's stack, a train state included, until ``gc`` runs
import torch._dynamo  # noqa: F401
from torch.distributed.tensor import DTensor

from repro_torch.core.resource_manager import HBM_BYTES_PER_CHIP
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, schedule
from repro_torch.sharding import parallel
from repro_torch.tracing import span
from repro_torch.util import tree_leaves, tree_map

TrainState = Dict[str, Any]


def make_train_state(cfg: ModelConfig, params: Any,
                     moment_dtype: torch.dtype = torch.float32) -> TrainState:
    device = parallel.local(tree_leaves(params)[0]).device
    return {"params": params, "opt": adamw.init(params, moment_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_train_state(cfg: ModelConfig,
                         moment_dtype: torch.dtype = torch.float32
                         ) -> TrainState:
    """A train state's tree, shapes and dtypes with no storage (fake
    tensors): the restore target, as the reference's ``jax.eval_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = transformer.init_params(cfg, torch.Generator(),
                                         device="cpu")
        return make_train_state(cfg, params, moment_dtype)


def microbatch_count(cfg: ModelConfig, global_batch: int, seq: int,
                     n_devices: int,
                     hbm_bytes: float = HBM_BYTES_PER_CHIP) -> int:
    """Pick a grad-accumulation factor so stored activations fit HBM
    (by default an H100's 80 GB).

    Per-layer remat stores one (mb, S, D) residual per layer; target that
    plus the optimizer footprint at ~60% of HBM.
    """
    layers = cfg.n_layers + cfg.n_encoder_layers
    bytes_per_mb = layers * seq * cfg.d_model * 2  # bf16 residuals, per sample
    # batch is sharded over the dp axes; assume dp covers all of n_devices/tp
    dp = max(1, n_devices // 16)
    local_batch = max(1, global_batch // dp)
    budget = 0.4 * hbm_bytes
    mb = 1
    while local_batch // mb > 1 and (local_batch // mb) * bytes_per_mb > budget:
        mb *= 2
    return min(mb, local_batch)


def value_and_grad(loss_of, params: Any) -> Tuple[torch.Tensor, Any]:
    """(loss, gradient tree) of ``loss_of(params)``: the counterpart of
    ``jax.value_and_grad``.  The params are not modified; a leaf the loss
    does not reach gets a zero gradient, as in JAX."""
    leaves = []

    def leaf(p):
        q = p.detach().requires_grad_(True)
        leaves.append(q)
        return q

    with span("train.forward"):
        loss = loss_of(tree_map(leaf, params))
    with span("train.backward"):
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(p):
        g = next(grads)
        if g is None:
            return torch.zeros_like(p)
        # a DTensor's gradient in its parameter's placements (a pending
        # sum, Partial, becomes the parameter's shard)
        if isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        return g
    return loss.detach(), tree_map(grad_of, params)


def make_train_step(cfg: ModelConfig, *, hyper: adamw.Hyper = adamw.Hyper(),
                    n_microbatches: int = 1, remat: bool = True,
                    act_spec=None, lr_schedule=None,
                    aux_coef: Optional[float] = None,
                    moe_groups: int = 1, moe_ep_axis=None,
                    accum_dtype: torch.dtype = torch.float32,
                    remat_policy=None):
    """Build the (state, batch) -> (state, metrics) step function.
    ``aux_coef`` weighs the MoE balance loss (default the configuration's
    ``moe_aux_alpha``).  ``remat_policy`` is passed to ``loss_fn``
    (``transformer.REMAT_POLICIES``; an unknown name raises)."""
    lr_schedule = lr_schedule or (lambda s: schedule.warmup_cosine(s))

    def loss_of(params, mb):
        return transformer.loss_fn(cfg, params, mb, aux_coef=aux_coef,
                                   remat=remat, act_spec=act_spec,
                                   moe_groups=moe_groups,
                                   moe_ep_axis=moe_ep_axis,
                                   remat_policy=remat_policy)

    def grads_of(params, batch):
        if n_microbatches == 1:
            with span("train.microbatch", mb=0):
                return value_and_grad(lambda p: loss_of(p, batch), params)

        def split(x, i):
            b = x.shape[0]
            assert b % n_microbatches == 0, (b, n_microbatches)
            n = b // n_microbatches
            return x[i * n:(i + 1) * n]

        tot_l = tot_g = None
        for i in range(n_microbatches):
            with span("train.microbatch", mb=i):
                mb = {k: split(v, i) for k, v in batch.items()}
                l, g = value_and_grad(lambda p: loss_of(p, mb), params)
                with span("train.accumulate"):
                    tot_l = l if tot_l is None else tot_l + l
                    if tot_g is None:
                        tot_g = tree_map(lambda x: x.to(accum_dtype), g)
                    else:
                        # shard by shard: a DTensor's gradient is already
                        # in its parameter's placements
                        tree_map(lambda a, x: parallel.local(a).add_(
                            parallel.local(x).to(accum_dtype)), tot_g, g)
                del g
        inv = 1.0 / n_microbatches
        with span("train.accumulate"):
            tree_map(lambda x: parallel.local(x).mul_(inv), tot_g)
            return tot_l * inv, tot_g

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, grads = grads_of(state["params"], batch)
        lr_scale = lr_schedule(state["step"])
        new_p, new_opt, om = adamw.update(state["params"], grads,
                                          state["opt"], state["step"],
                                          hyper, lr_scale)
        del grads
        new_state = {"params": new_p, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss,
                   "lr_scale": torch.as_tensor(lr_scale,
                                               dtype=torch.float32),
                   **om}
        return new_state, metrics

    return train_step
