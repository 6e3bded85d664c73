"""The port on more than one device: gloo ranks on the CPU through
``launch/spmd.py``, at smoke sizes.

The port of ``tests/test_multidevice.py``'s first three cases (sharded
training equals one device, the elastic shrink with a checkpoint
resharded onto the survivors, a gang CU on a multi-device grid), plus:
Hymba's Mamba layer with its channels split over "model" (loss and
every gradient against one device), the expert-parallel MoE combine
against the GSPMD one on a (2, 2) mesh, and the port's one-device plan
path against the reference ``Trainer``.  Every spawn has its own
timeout (``spmd.run(..., timeout=)``, ``Trainer.run(..., timeout=)``),
so a hung rank fails its case.  The reference's own cases allow 2e-2;
these allow at most 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import (ComputeUnitDescription, DeviceGrid,
                              PilotDescription, PilotManager, ResourceManager)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import spmd
from repro_torch.models import transformer
from repro_torch.models.layers import moe
from repro_torch.sharding import Plan, parallel
from repro_torch.train.step import value_and_grad
from repro_torch.train.trainer import Trainer
from repro_torch.util import tree_paths

CPU = torch.device("cpu")
RANK_TIMEOUT = 300.0


def _grid(dp, tp):
    return DeviceGrid([CPU] * (dp * tp), tp=tp)


def _losses(cfg, grid, steps, **kw):
    tr = Trainer(cfg, grid, global_batch=4, seq=16, **kw)
    return [h["loss"] for h in tr.run(steps, log_every=0,
                                      timeout=RANK_TIMEOUT)]


# ------------------------------------------------- reference's cases
def test_sharded_training_matches_single_device():
    """The same seed on a (2, 2) grid (4 gloo ranks: FSDP + TP) and on
    one device gives the same losses."""
    cfg = configs.get_smoke("internlm2-1.8b")
    want = _losses(cfg, _grid(1, 1), 4, seed=5)
    got = _losses(cfg, _grid(2, 2), 4, seed=5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_elastic_shrink_reshard_restore(tmp_path):
    """Train on 4 devices, checkpoint, lose half the pilot, restore onto
    the surviving (1, 2) grid and go on: the checkpoint reshards."""
    cfg = configs.get_smoke("yi-6b")
    d = str(tmp_path)
    pm = PilotManager(ResourceManager(devices=[CPU] * 4))
    try:
        pilot = pm.submit(PilotDescription(n_chips=4, tp=2))
        tr = Trainer(cfg, pilot.mesh(), global_batch=4, seq=16, ckpt_dir=d,
                     ckpt_every=3, seed=7)
        tr.run(6, log_every=0, timeout=RANK_TIMEOUT)
        pilot.fail_device(pilot.devices[-1])
        pilot.fail_device(pilot.devices[-1])
        assert len(pilot.devices) == 2
        mesh2 = pilot.mesh(tp=2)
        assert mesh2.shape == {"data": 1, "model": 2}
        tr2 = Trainer(cfg, mesh2, global_batch=4, seq=16, ckpt_dir=d, seed=7)
        assert tr2.restore() == 6
        hist = tr2.run(8, log_every=0, timeout=RANK_TIMEOUT)
        assert [h["step"] for h in hist] == [6, 7]
    finally:
        pm.shutdown()
    ref = Trainer(cfg, _grid(1, 1), global_batch=4, seq=16, seed=7)
    want = {h["step"]: h["loss"] for h in ref.run(8, log_every=0)}
    for h in hist:
        np.testing.assert_allclose(h["loss"], want[h["step"]], rtol=1e-4)


def _sum_of_squares(mesh):
    """A (8, 2) tensor split over ("data", "model"): every rank squares
    its shard, the sum is all-reduced."""
    from torch.distributed.tensor import Shard, distribute_tensor
    x = distribute_tensor(torch.arange(16.0).reshape(8, 2), mesh,
                          [Shard(0), Shard(1)])
    return float((x * x).sum().full_tensor()), mesh.size()


def _world(mesh):
    return mesh.size()


def test_pilot_gang_mesh_multidevice():
    """A gang CU gets a grid of its devices that ``spmd.run`` drives as
    that many ranks; two 2-chip CUs then run side by side."""
    pm = PilotManager(ResourceManager(devices=[CPU] * 4))
    try:
        pilot = pm.submit(PilotDescription(n_chips=4, tp=2))

        def hpc(mesh=None):
            assert mesh.size == 4 and mesh.shape == {"data": 2, "model": 2}
            return spmd.run(mesh, _sum_of_squares, timeout=RANK_TIMEOUT)

        cu = pilot.submit(ComputeUnitDescription(fn=hpc, gang=True,
                                                 n_chips=4))
        assert cu.wait(RANK_TIMEOUT) == (float(sum(i * i for i in range(16))),
                                         4)
        cus = [pilot.submit(ComputeUnitDescription(
            fn=lambda mesh=None: spmd.run(mesh, _world,
                                          timeout=RANK_TIMEOUT),
            gang=True, n_chips=2)) for _ in range(2)]
        assert [c.wait(RANK_TIMEOUT) for c in cus] == [2, 2]
    finally:
        pm.shutdown()


# ------------------------------------------------- layers under TP / EP
def _inputs(arch, seed):
    """The port's smoke params and one (4, 16) batch, from `seed`."""
    cfg = configs.get_smoke(arch)
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu")
    batch = TokenPipeline(cfg, batch=4, seq=16, seed=seed,
                          device=CPU).batch_at(0)
    return params, batch


def _grads(mesh, cfg, ep_axis, params, batch):
    """Loss and full gradients of one smoke step on `mesh`, the params
    placed by the plan and ``moe_groups = plan.dp_size``; how often the
    EP combine ran; whether each gradient is in its param's placements."""
    plan = Plan.for_mesh(mesh)
    placed = parallel.distribute_tree(params, plan.param_specs(params), mesh)
    calls = []
    real = moe._combine_ep
    moe._combine_ep = lambda *a: calls.append(1) or real(*a)
    try:
        loss, grads = value_and_grad(lambda p: transformer.loss_fn(
            cfg, p, batch, act_spec=plan.act_spec(),
            moe_groups=plan.dp_size, moe_ep_axis=ep_axis), placed)
    finally:
        moe._combine_ep = real
    full = parallel.host_tree(grads)
    return (float(loss), {p: g for p, g in tree_paths(full)}, len(calls),
            {p: tuple(g.placements) == tuple(q.placements)
             for (p, g), (_, q) in zip(tree_paths(grads),
                                       tree_paths(placed))})


def _assert_grads_close(got, want, tol):
    assert got[0] == pytest.approx(want[0], rel=tol)
    assert set(got[1]) == set(want[1])
    assert all(got[3].values()), "a gradient is not in its param's placements"
    for path, w in want[1].items():
        g, w = got[1][path].float(), w.float()
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g - w).abs().max()) / scale
        assert err <= tol, (path, err)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_hymba_mamba_under_tp(shape):
    """Hymba smoke: its Mamba layer's 128 channels split over "model"
    (K3's plain version and the fused backward's on each rank's shard,
    in_proj sliced, x_proj and out_proj all-reduced), its 5 heads
    replicated: the loss and every gradient equal one device's."""
    cfg = configs.get_smoke("hymba-1.5b")
    inputs = _inputs("hymba-1.5b", 11)
    want = spmd.run(_grid(1, 1), _grads, cfg, None, *inputs)
    got = spmd.run(_grid(*shape), _grads, cfg, None, *inputs,
                   timeout=RANK_TIMEOUT)
    _assert_grads_close(got, want, 1e-4)


def test_gqa_kv_heads_sliced_under_tp():
    """internlm2 smoke on (1, 4): its 4 query heads split over "model",
    one a rank, while its 2 kv heads do not divide, so the plan leaves
    ``wk``/``wv`` whole and each rank takes the kv head of its query head
    (their gradients summed over "model"): the loss and every gradient
    equal one device's."""
    cfg = configs.get_smoke("internlm2-1.8b")
    inputs = _inputs("internlm2-1.8b", 19)
    want = spmd.run(_grid(1, 1), _grads, cfg, None, *inputs)
    got = spmd.run(_grid(1, 4), _grads, cfg, None, *inputs,
                   timeout=RANK_TIMEOUT)
    _assert_grads_close(got, want, 1e-4)


def test_moe_expert_parallel_matches_gspmd():
    """Qwen2-MoE smoke on (2, 2): with ``moe_ep_axis="model"`` each model
    rank runs its 8 of the 16 experts and the partial combines are
    summed; forward and every gradient equal the GSPMD combine's (every
    rank runs every expert)."""
    cfg = configs.get_smoke("qwen2-moe-a2.7b")
    inputs = _inputs("qwen2-moe-a2.7b", 13)
    gspmd = spmd.run(_grid(2, 2), _grads, cfg, None, *inputs,
                     timeout=RANK_TIMEOUT)
    ep = spmd.run(_grid(2, 2), _grads, cfg, "model", *inputs,
                  timeout=RANK_TIMEOUT)
    n_moe = cfg.n_layers
    # each MoE layer's forward, and its recomputation under remat
    assert gspmd[2] == 0 and ep[2] == 2 * n_moe
    _assert_grads_close(ep, gspmd, 1e-5)


@pytest.mark.parametrize("shape,ep_axis", [((2, 1), None),
                                           ((2, 2), "model")],
                         ids=["gspmd-2x1", "ep-2x2"])
def test_moe_data_parallel_routing_matches_reference(shape, ep_axis):
    """Qwen2-MoE smoke with ``moe_groups = plan.dp_size`` (2): each data
    rank routes its own batch rows as its group, and the load-balance
    loss's expert means and counts are summed over the data ranks.  The
    loss and every gradient (the router's included) equal the
    reference's ``jax.value_and_grad(loss_fn)`` on one device with the
    same ``moe_groups``, from one converted state, at 1e-4: through the
    GSPMD combine on (2, 1) and the expert-parallel one on (2, 2).  The
    capacity factor is 1, so tokens drop and a wrong split of the groups
    over the ranks changes the result."""
    import dataclasses
    import jax
    from repro import configs as jconfigs
    from repro.data.pipeline import TokenPipeline as JPipeline
    from repro.models import transformer as jtransformer
    from repro_torch.convert import params_from_numpy, to_tensor
    arch = "qwen2-moe-a2.7b"
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               moe_capacity_factor=1.0)
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              moe_capacity_factor=1.0)
    jparams = jtransformer.init_params(jcfg, jax.random.key(17))
    jbatch = JPipeline(jcfg, batch=4, seq=16, seed=17).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(jcfg, p, b, moe_groups=shape[0])))(
            jparams, jbatch)
    want = (float(loss), {p: to_tensor(np.asarray(g)) for p, g in
                          tree_paths(jax.tree.map(np.asarray, grads))})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    batch = {k: to_tensor(np.asarray(v)) for k, v in jbatch.items()}
    got = spmd.run(_grid(*shape), _grads, cfg, ep_axis, params, batch,
                   timeout=RANK_TIMEOUT)
    assert got[2] == (0 if ep_axis is None else 2 * cfg.n_layers)
    _assert_grads_close(got, want, 1e-4)


def _failing(mesh):
    if mesh.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()     # the others wait for it: stopped
    return "unreachable"


def test_a_failing_rank_fails_the_call():
    with pytest.raises(spmd.RankError, match="rank 1 fails on purpose"):
        spmd.run(_grid(1, 2), _failing, timeout=RANK_TIMEOUT)


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "internlm2-1.8b"])
def test_one_device_plan_path_matches_reference(arch):
    """The port's Trainer on a 1 x 1 grid (the DTensor plan path) and the
    reference's on a 1 x 1 mesh, from one converted state: 5 steps of
    loss, grad norm and lr scale at rel 1e-4."""
    import jax
    from repro import compat
    from repro import configs as jconfigs
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.convert import train_state_from_numpy
    kw = dict(global_batch=4, seq=32, seed=0, warmup_steps=2, total_steps=10)
    jtr = JTrainer(jconfigs.get_smoke(arch),
                   compat.make_mesh((1, 1), ("data", "model")), **kw)
    jtr.init_state()
    ttr = Trainer(configs.get_smoke(arch), _grid(1, 1), **kw)
    ttr.state = train_state_from_numpy(jax.tree.map(np.array, jtr.state),
                                       CPU)
    want = jtr.run(5, log_every=0)
    got = ttr.run(5, log_every=0)
    assert parallel.is_sharded(ttr.state["params"])
    for key in ("loss", "grad_norm", "lr_scale"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=1e-4,
                                   err_msg=key)


def test_checkpoint_of_a_sharded_state_is_the_full_layout(tmp_path):
    """A 4-rank run's checkpoint holds every leaf whole, as a one-device
    run's does; restored on one device, the state equals what the
    4-rank trainer handed back."""
    cfg = configs.get_smoke("llama3.2-1b")
    tr = Trainer(cfg, _grid(2, 2), global_batch=4, seq=16, seed=2,
                 ckpt_dir=str(tmp_path))
    tr.run(2, log_every=0, timeout=RANK_TIMEOUT)
    one = Trainer(cfg, _grid(1, 1), global_batch=4, seq=16, seed=2,
                  ckpt_dir=str(tmp_path))
    assert one.restore() == 2
    got = dict(tree_paths(parallel.host_tree(one.state)))
    for path, t in tree_paths(tr.state):
        assert torch.equal(got[path], t), path


def _host_copies(mesh):
    """Each rank gathers a sharded leaf for a checkpoint and for the
    trainer's hand-back; only rank 0 copies it to the host."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.checkpoint import manager
    tree = {"w": distribute_tensor(torch.arange(8.0).reshape(4, 2), mesh,
                                   [Shard(0), Shard(1)])}
    rank0 = mesh.get_rank() == 0
    arrays = manager._flatten(tree, rank0)
    host = parallel.host_tree(tree, keep=rank0)
    if not rank0:
        assert arrays == {} and host is None, (arrays, host)
        return None
    return arrays["w"].tolist(), host["w"].tolist()


def test_only_rank_zero_copies_the_state_to_the_host():
    want = torch.arange(8.0).reshape(4, 2).tolist()
    assert spmd.run(_grid(2, 2), _host_copies,
                    timeout=RANK_TIMEOUT) == (want, want)
