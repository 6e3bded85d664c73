"""The ``save_tp_out`` remat policy and sequence parallelism on gloo
ranks (``launch/spmd.py``), smoke configs, one batch of 4 x 16.

* ``save_tp_out`` on (1, 2): the loss and every gradient equal the
  no-policy step's (rel 1e-6; bit for bit is printed), and the backward
  issues fewer all-reduces (``CommDebugMode``): the recompute of each
  layer takes the saved sum of its sharded sublayers instead of summing
  again.  Both are also held against the reference's
  ``jax.value_and_grad(loss_fn)`` on one device (1e-4).  On a 1 x 1
  mesh (no collective to save) the policy changes nothing, bit for bit.
* Sequence parallelism (``Plan.act_spec(sp=True)``) on (1, 2) and
  (2, 2), Hymba (its Mamba channels split over "model", its heads
  replicated) and internlm2 (heads and MLP split), with and without
  ``save_tp_out``: the loss and every gradient within 1e-4 of the
  reference's ``jax.value_and_grad(loss_fn)`` on one device, from the
  same converted params and batch, and within 1e-4 of the port's own
  ``sp=False`` step; each layer's input is this rank's chunk of the
  sequence.

Every spawn has its own timeout.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import DeviceGrid
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import spmd
from repro_torch.models import transformer
from repro_torch.sharding import Plan, parallel
from repro_torch.util import tree_leaves, tree_paths

CPU = torch.device("cpu")
RANK_TIMEOUT = 300.0
B, S = 4, 16


def _inputs(arch, seed):
    cfg = configs.get_smoke(arch)
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu")
    batch = TokenPipeline(cfg, batch=B, seq=S, seed=seed,
                          device=CPU).batch_at(0)
    return params, batch


@functools.lru_cache(maxsize=None)
def _reference(arch, seed):
    """The reference's loss and gradients (``jax.value_and_grad(loss_fn)``
    on one device), and its params and batch converted for the port."""
    import jax
    from repro import configs as jconfigs
    from repro.data.pipeline import TokenPipeline as JPipeline
    from repro.models import transformer as jtransformer
    from repro_torch.convert import params_from_numpy, to_tensor
    jcfg = jconfigs.get_smoke(arch)
    jparams = jtransformer.init_params(jcfg, jax.random.key(seed))
    jbatch = JPipeline(jcfg, batch=B, seq=S, seed=seed).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(jcfg, p, b)))(jparams, jbatch)
    want = (float(loss), {p: to_tensor(np.asarray(g)) for p, g in
                          tree_paths(jax.tree.map(np.asarray, grads))})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    batch = {k: to_tensor(np.asarray(v)) for k, v in jbatch.items()}
    return want, params, batch


def _assert_close(got, want, tol):
    assert got[0] == pytest.approx(want[0], rel=tol)
    assert set(got[1]) == set(want[1])
    assert _max_rel(got[1], want[1]) <= tol


def _variants(mesh, arch, variants, params, batch):
    """For each (sp, remat_policy) variant: the loss, the full gradients
    by path, the all-reduces the backward issued, and the shapes of the
    layers' inputs."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = configs.get_smoke(arch)
    plan = Plan.for_mesh(mesh)
    placed = parallel.distribute_tree(params, plan.param_specs(params), mesh)
    leaves = tree_leaves(placed)
    for t in leaves:
        t.requires_grad_(True)
    shapes = []
    real = transformer.block_forward

    def recorded(cfg_, seg, p, x, *a, **k):
        shapes.append(tuple(x.shape))
        return real(cfg_, seg, p, x, *a, **k)

    transformer.block_forward = recorded
    out = []
    try:
        for sp, policy in variants:
            shapes.clear()
            loss = transformer.loss_fn(
                cfg, placed, batch, act_spec=plan.act_spec(sp=sp),
                moe_groups=plan.dp_size, remat_policy=policy)
            with CommDebugMode() as comm:
                grads = torch.autograd.grad(loss, leaves)
            reduces = sum(n for op, n in comm.get_comm_counts().items()
                          if "all_reduce" in str(op) or "allreduce" in str(op))
            full = {p: g.full_tensor()
                    for (p, _), g in zip(tree_paths(placed), grads)}
            out.append((float(loss.detach()), full, reduces,
                        sorted(set(shapes))))
    finally:
        transformer.block_forward = real
    return out


def _max_rel(got, want):
    return max(float((got[p].float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-12)
               for p, w in want.items())


def _bitwise(a, b):
    return a[0] == b[0] and all(torch.equal(a[1][p], g)
                                for p, g in b[1].items())


def test_save_tp_out_matches_no_policy_with_fewer_all_reduces():
    arch = "internlm2-1.8b"
    want, params, batch = _reference(arch, 21)
    base, saved = spmd.run(DeviceGrid([CPU] * 2, tp=2), _variants, arch,
                           [(False, None), (False, "save_tp_out")],
                           params, batch, timeout=RANK_TIMEOUT)
    print("save_tp_out bit for bit:", _bitwise(saved, base),
          "max rel", _max_rel(saved[1], base[1]),
          "backward all-reduces", base[2], "->", saved[2])
    assert saved[0] == pytest.approx(base[0], rel=1e-6)
    assert _max_rel(saved[1], base[1]) <= 1e-6
    assert saved[2] < base[2]
    for got in (base, saved):
        _assert_close(got, want, 1e-4)


def test_save_tp_out_is_a_no_op_on_one_device():
    arch = "hymba-1.5b"
    base, saved = spmd.run(DeviceGrid([CPU]), _variants, arch,
                           [(False, None), (False, "save_tp_out")],
                           *_inputs(arch, 22))
    assert _bitwise(saved, base) and saved[2] == base[2] == 0


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "internlm2-1.8b"])
def test_sequence_parallel_matches(arch, shape):
    dp, tp = shape
    want, params, batch = _reference(arch, 23)
    base, sp, sp_saved = spmd.run(
        DeviceGrid([CPU] * (dp * tp), tp=tp), _variants, arch,
        [(False, None), (True, None), (True, "save_tp_out")],
        params, batch, timeout=RANK_TIMEOUT)
    d = configs.get_smoke(arch).d_model
    # the residual stream: this rank's batch rows, the whole sequence
    # without sequence parallelism, its chunk with it
    assert base[3] == [(B // dp, S, d)]
    assert sp[3] == sp_saved[3] == [(B // dp, S // tp, d)]
    for got in (sp, sp_saved):
        errs = (_max_rel(got[1], want[1]), _max_rel(got[1], base[1]))
        print(arch, shape, "max rel vs the reference, vs sp=False:", errs)
        _assert_close(got, want, 1e-4)
        _assert_close(got, base, 1e-4)
