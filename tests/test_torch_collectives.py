"""The collective-byte counter (``roofline/collectives.py``), in place of
the reference's two HLO-parser cases.

Each case runs in a subprocess of its own (this file run as a script),
with a timeout, since it initialises a ``"fake"`` process group that
must not outlive the case:

* on a fake (4,) and (2, 2) group under ``FakeTensorMode``: one FSDP
  all-gather of a (8, 16) f32 leaf (``parallel.Ctx.localize``), one
  reduce-scatter (a ``Partial`` DTensor redistributed to ``Shard(0)``),
  one all-reduce (``Group.all_reduce``, the in-place ``c10d`` op) and
  one functional all-reduce (``Group.reduce_out``) give exactly the
  hand-worked bytes of the reference's conventions;
* one sharded train step of a smoke config with 1, 2 and 4 layers on a
  fake (2, 2) group: the bytes grow by the same amount a layer, so the
  4-layer step's excess over the 2-layer one is twice the 2-layer
  step's over the 1-layer one (the counterpart of the reference's
  while-loop trip-count case: a dynamic trace issues a layer's
  collectives once a layer).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300


def _run(case: str, *args: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, __file__, case, *args],
                         capture_output=True, text=True, timeout=TIMEOUT,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _hand_worked(mesh_shape: str) -> dict:
    """Per-device bytes of the four collectives, worked by hand."""
    leaf = 8 * 16 * 4                    # the (8, 16) f32 leaf, whole
    if mesh_shape == "4":
        # FSDP over the 4 ranks: gather the whole leaf, 3/4 of it arrives;
        # the reduce-scatter leaves a (2, 16) shard and sends 3 of them;
        # each all-reduce (ring) moves 2 x 3/4 of its operand
        return {"all-gather": leaf * 3 / 4,
                "reduce-scatter": (leaf / 4) * 3,
                "all-reduce": 2 * (2 * leaf * 3 / 4)}
    # (2, 2): the leaf split over "data" is gathered over its 2 ranks;
    # the reduce-scatter over "data" keeps a (4, 16) half and sends one;
    # the all-reduces run over "model" (2 ranks): 2 x 1/2 of the operand
    return {"all-gather": leaf / 2, "reduce-scatter": leaf / 2,
            "all-reduce": 2 * (2 * leaf / 2)}


@pytest.mark.parametrize("mesh_shape", ["4", "2x2"])
def test_payload_conventions_on_a_fake_group(mesh_shape):
    got = _run("payloads", mesh_shape)
    want = _hand_worked(mesh_shape)
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert got[kind] == want[kind], (kind, got)
    assert got["all-to-all"] == got["collective-permute"] == 0.0
    assert got["total"] == sum(want.values())
    # the ops seen: one gather, one reduce-scatter, two all-reduces (the
    # in-place c10d one and the functional one)
    assert got["kinds"] == ["all-gather", "reduce-scatter", "all-reduce",
                            "all-reduce"]


def test_per_layer_collectives_scale_with_depth():
    got = _run("depth", "llama3.2-1b", "1", "2", "4")
    b1, b2, b4 = (got[str(n)]["total"] for n in (1, 2, 4))
    assert b1 > 0 and b2 > b1
    assert b4 - b2 == 2 * (b2 - b1), got
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        k1, k2, k4 = (got[str(n)][kind] for n in (1, 2, 4))
        assert k4 - k2 == 2 * (k2 - k1), (kind, got)


# ------------------------------------------------------- the subprocess
def _payloads(mesh_shape: str) -> dict:
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.roofline.collectives import CollectiveCounter
    from repro_torch.sharding import parallel
    shape = tuple(int(n) for n in mesh_shape.split("x"))
    names = ("data",) if len(shape) == 1 else ("data", "model")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(torch.tensor(shape).prod()))
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        rest = [Replicate()] * (len(shape) - 1)
        ctx = parallel.Ctx(mesh, ["data"])
        tp = parallel.Group(mesh, names[-1])
        with FakeTensorMode():
            n = shape[0]
            leaf = DTensor.from_local(torch.empty(8 // n, 16), mesh,
                                      [Shard(0), *rest], run_check=False)
            part = DTensor.from_local(torch.empty(8, 16), mesh,
                                      [Partial(), *rest], run_check=False)
            act = torch.empty(8, 16)
            with CollectiveCounter() as counter:
                ctx.localize(leaf)                       # FSDP gather
                part.redistribute(mesh, [Shard(0), *rest])
                tp.all_reduce(act)                       # c10d.allreduce_
                tp.reduce_out(act)                       # functional
        out = counter.bytes()
        out["kinds"] = [kind for kind, *_ in counter.calls]
        return out
    finally:
        dist.destroy_process_group()


def _depth(arch: str, *layers: str) -> dict:
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import configs
    from repro_torch.data.batches import make_batch
    from repro_torch.models import transformer
    from repro_torch.roofline.collectives import collective_bytes_per_device
    from repro_torch.sharding import Plan, parallel
    from repro_torch.train.step import make_train_state, make_train_step
    import numpy as np
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    out = {}
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        plan = Plan.for_mesh(mesh)
        for n in layers:
            cfg = dataclasses.replace(configs.get_smoke(arch),
                                      n_layers=int(n))
            batch = make_batch(cfg, "train", 4, 16,
                               np.random.default_rng(0), device="cpu")
            with FakeTensorMode(allow_non_fake_inputs=True):
                params = transformer.init_params(cfg, torch.Generator(),
                                                 device="cpu")
                state = make_train_state(cfg, params)
                held = parallel.distribute_tree(
                    state, plan.param_specs(state), mesh)
                step = make_train_step(cfg, act_spec=plan.act_spec(),
                                       moe_groups=plan.dp_size)
                out[n] = collective_bytes_per_device(step, held, batch)
        return out
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, *rest = sys.argv[1:]
    fn = {"payloads": _payloads, "depth": _depth}[case]
    print(json.dumps(fn(*rest)))
