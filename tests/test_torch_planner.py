"""The port's sharding planner against the reference's, spec for spec.

For all 10 configs at full size, on the meshes (16, 16), (2, 16, 16),
(2, 2), (4, 1), (1, 4) and (1, 1), for training and for serving: the
port's ``param_specs``, ``batch_specs``, ``cache_specs``, ``act_spec``
and ``logits_spec`` equal the reference's ``PartitionSpec``s as tuples,
leaf by leaf.  The reference plans ``jax.eval_shape`` trees, the port
fake (params) and meta (caches) tensors: neither allocates a 236B
model.  Then the four cases of ``tests/test_planner_properties.py`` on
the port, with the same ``hypothesis`` strategies, and the DTensor
placements a spec gives.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.sharding.planner import Plan as JPlan

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.sharding import Plan, Spec, placements
from repro_torch.train.step import abstract_train_state
from repro_torch.util import tree_leaves

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

ARCHS = configs.names()
MESHES = [(16, 16), (2, 16, 16), (2, 2), (4, 1), (1, 4), (1, 1)]
BATCH, SEQ = 32, 256


def _axes(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return dict(zip(names, shape))


def _plans(shape, serving=False):
    axes = _axes(shape)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    return (JPlan(mesh_axes=axes, dp_axes=dp, serving=serving),
            Plan(mesh_axes=axes, dp_axes=dp, serving=serving))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jconfigs.get(arch)
    return jax.eval_shape(
        lambda: jtransformer.init_params(cfg, jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return abstract_train_state(configs.get(arch))["params"]


def _ref_leaves(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _port_leaves(tree):
    """Specs in ``jax.tree.leaves`` order (sorted dict keys); a Spec is a
    tuple, so it is a leaf here, as a PartitionSpec is there."""
    if isinstance(tree, Spec):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_leaves(tree[k])]
    return [s for v in tree for s in _port_leaves(v)]


def test_for_mesh_reads_a_grid_a_device_mesh_and_a_dict():
    from repro_torch.core import DeviceGrid
    from repro_torch.launch import mesh, spmd
    cpu = torch.device("cpu")
    want = Plan(mesh_axes={"data": 2, "model": 2}, dp_axes=("data",))
    assert Plan.for_mesh(DeviceGrid([cpu] * 4, tp=2)) == want
    assert Plan.for_mesh({"data": 2, "model": 2}) == want
    assert Plan.for_mesh(mesh.make_mesh_for(4, tp=2)) == want
    grid = mesh.make_mesh_for(4, tp=2, devices=[cpu] * 4)
    assert isinstance(grid, DeviceGrid) and Plan.for_mesh(grid) == want
    assert Plan.for_mesh(mesh.make_production_mesh(multi_pod=True)) == Plan(
        mesh_axes={"pod": 2, "data": 16, "model": 16},
        dp_axes=("pod", "data"))
    dm = spmd.local_mesh(DeviceGrid([cpu]))
    assert Plan.for_mesh(dm) == Plan(mesh_axes={"data": 1, "model": 1},
                                     dp_axes=("data",))


@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, shape, serving):
    jplan, plan = _plans(shape, serving)
    want = _ref_leaves(jplan.param_specs(_ref_params(arch)))
    got = _port_leaves(plan.param_specs(_port_params(arch)))
    assert got == want


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_act_logits_specs_equal_reference(arch, shape):
    jplan, plan = _plans(shape)
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    enc = SEQ if cfg.is_encoder_decoder else 0
    for batch in (1, 3, 4, BATCH):
        jb = {"tokens": jax.ShapeDtypeStruct((batch, SEQ), jnp.int32),
              "mask": jax.ShapeDtypeStruct((batch, SEQ), jnp.float32)}
        tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
        assert (_port_leaves(plan.batch_specs(tb))
                == _ref_leaves(jplan.batch_specs(jb)))
        assert tuple(plan.logits_spec(batch)) == tuple(
            jplan.logits_spec(batch))
    jc = jax.eval_shape(
        lambda: jtransformer.init_caches(jcfg, BATCH, SEQ, enc))
    tc = transformer.init_caches(cfg, BATCH, SEQ, enc, device="meta")
    assert (_port_leaves(plan.cache_specs(cfg, tc))
            == _ref_leaves(jplan.cache_specs(jcfg, jc)))
    for sp in (False, True):
        assert tuple(plan.act_spec(sp)) == tuple(jplan.act_spec(sp))
    assert tuple(plan.logits_spec()) == tuple(jplan.logits_spec())


def test_spec_canonicalizes_like_partition_spec():
    for entries in [(("data",), None), (("pod", "data"), None), (),
                    (None, "model"), ((), "model")]:
        assert tuple(Spec(*entries)) == tuple(P(*entries))


@pytest.mark.parametrize("shape,spec,want", [
    ((2, 2), Spec("data", "model"), ("S0", "S1")),
    ((2, 2), Spec(None, "data"), ("S1", "R")),
    ((1, 2), Spec("data", "model"), ("R", "S1")),     # size-1 axis
    ((2, 2, 2), Spec(("pod", "data"), None), ("S0", "S0", "R")),
    ((2, 1, 2), Spec(("pod", "data"), "model"), ("S0", "R", "S1")),
])
def test_placements_of_a_spec(shape, spec, want):
    from torch.distributed.tensor import Replicate, Shard

    class FakeMesh:                 # placements reads names and sizes
        mesh_dim_names = tuple(_axes(shape))

    FakeMesh.shape = shape
    got = placements(spec, FakeMesh)
    assert got == [Replicate() if w == "R" else Shard(int(w[1]))
                   for w in want]
    with pytest.raises(ValueError, match="order"):
        placements(Spec(("data", "pod")), type(
            "M", (), {"mesh_dim_names": ("pod", "data", "model"),
                      "shape": (2, 2, 2)}))


# ------------------------------------ tests/test_planner_properties.py
def _make_plan(data=16, model=16, pod=0, **kw):
    axes = {"pod": pod, "data": data, "model": model} if pod else \
        {"data": data, "model": model}
    dp = tuple(a for a in ("pod", "data") if a in axes)
    return Plan(mesh_axes=axes, dp_axes=dp, **kw)


def _divides(plan, shape, spec):
    for dim, ax in zip(shape, tuple(spec) + (None,) * 8):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if dim % plan.mesh_axes[a]:
                return False
    return True


@settings(max_examples=30, deadline=None)
@given(data=st.sampled_from([1, 2, 4, 8, 16]),
       model=st.sampled_from([1, 2, 4, 8, 16]),
       arch=st.sampled_from(configs.names()))
def test_param_specs_always_valid(data, model, arch):
    """Every produced spec divides its dim, for any mesh and any arch,
    and equals the reference's."""
    cfg = configs.get_smoke(arch)
    params = abstract_train_state(cfg)["params"]
    plan = _make_plan(data, model)
    specs = _port_leaves(plan.param_specs(params))
    leaves = tree_leaves(params)
    assert len(leaves) == len(specs)
    for leaf, spec in zip(leaves, specs):
        assert len(spec) <= len(leaf.shape)
        assert _divides(plan, leaf.shape, spec), (arch, leaf.shape, spec)
    jparams = jax.eval_shape(lambda: jtransformer.init_params(
        jconfigs.get_smoke(arch), jax.random.key(0)))
    jplan = JPlan(mesh_axes=plan.mesh_axes, dp_axes=plan.dp_axes)
    assert specs == _ref_leaves(jplan.param_specs(jparams))


@settings(max_examples=30, deadline=None)
@given(batch=st.integers(1, 512), data=st.sampled_from([2, 4, 8, 16]),
       pod=st.sampled_from([0, 2]))
def test_batch_spec_divisibility(batch, data, pod):
    plan = _make_plan(data=data, pod=pod)
    spec = plan.batch_specs({"x": torch.empty(batch, 8, device="meta")})
    axes = spec["x"][0]
    if axes:
        if isinstance(axes, str):  # Spec canonicalizes singleton tuples
            axes = (axes,)
        prod = 1
        for a in axes:
            prod *= plan.mesh_axes[a]
        assert batch % prod == 0


@settings(max_examples=20, deadline=None)
@given(arch=st.sampled_from(configs.names()),
       batch=st.sampled_from([1, 4, 16, 128]),
       seq=st.sampled_from([64, 2048]))
def test_cache_specs_always_valid(arch, batch, seq):
    cfg = configs.get_smoke(arch)
    caches = transformer.init_caches(
        cfg, batch, seq, seq if cfg.is_encoder_decoder else 0,
        device="meta")
    plan = _make_plan()
    specs = plan.cache_specs(cfg, caches)
    for leaf, spec in zip(tree_leaves(caches), _port_leaves(specs)):
        assert _divides(plan, leaf.shape, spec), (arch, leaf.shape, spec)


def test_serving_plan_drops_fsdp_only_with_tp():
    """Weight-stationary mode: TP leaves lose FSDP; non-TP leaves keep
    it."""
    params = abstract_train_state(configs.get_smoke("deepseek-67b"))[
        "params"]
    train = _port_leaves(_make_plan().param_specs(params))
    serve = _port_leaves(_make_plan(serving=True).param_specs(params))
    changed = 0
    for t, s in zip(train, serve):
        if "model" in t and "data" in t:
            assert "data" not in s and "model" in s
            changed += 1
        else:
            assert t == s
    assert changed > 0
