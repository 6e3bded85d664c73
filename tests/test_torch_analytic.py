"""The port's analytic cost model and ``StageCost.from_model`` against
the JAX reference.

* ``forward_flops``, ``step_cost`` and ``_cache_bytes`` equal the
  reference's exactly (``==``) for all 10 configs x the applicable
  ``SHAPES``, at 256 and 512 devices with tp 16 and at one device (tp 1,
  2 microbatches).
* ``tests/test_roofline.py::test_step_cost_sanity`` on the port.
* In place of the reference's XLA ``cost_analysis`` cross-check:
  ``torch.utils.flop_counter.FlopCounterMode`` over the port's forward
  of the same 1-layer llama (B 4, S 256), ratio within 0.7-1.4.
* ``StageCost.from_model`` equals the reference's for every config's
  train shape, and a Session places a stage carrying one on the pilot
  with the larger advertised peak FLOP/s, recording its estimate, its
  actual runtime and their ratio.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.config import SHAPES as JSHAPES
from repro.roofline import analytic as janalytic
from repro.roofline.placement import StageCost as JStageCost

from repro_torch import configs
from repro_torch.core import (PilotDescription, ResourceManager, Session,
                              TransferCostModel, hpc_stage)
from repro_torch.data.batches import make_batch
from repro_torch.models import transformer
from repro_torch.models.config import SHAPES, ShapeConfig, shape_applicable
from repro_torch.roofline import StageCost, analytic

MESHES = {"pod16x16": dict(n_devices=256, tp=16),
          "pod2x16x16": dict(n_devices=512, tp=16),
          "one": dict(n_devices=1, tp=1, n_microbatches=2)}


def _pairs(arch):
    return configs.get(arch), jconfigs.get(arch)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.names())
def test_costs_equal_reference_exactly(arch, mesh):
    cfg, jcfg = _pairs(arch)
    kw = MESHES[mesh]
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        jshape = JSHAPES[name]
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            got = analytic.forward_flops(cfg, B, 1, S_kv=S, decode=True)
            want = janalytic.forward_flops(jcfg, B, 1, S_kv=S, decode=True)
        else:
            got = analytic.forward_flops(cfg, B, S)
            want = janalytic.forward_flops(jcfg, B, S)
        assert got == want, (name, got, want)
        assert analytic._cache_bytes(cfg, B, S) == \
            janalytic._cache_bytes(jcfg, B, S), name
        got = analytic.step_cost(cfg, shape, **kw)
        want = janalytic.step_cost(jcfg, jshape, **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), name
        for remat in (True, False):
            assert analytic.step_cost(cfg, shape, remat=remat, **kw).flops \
                == janalytic.step_cost(jcfg, jshape, remat=remat, **kw).flops


def test_step_cost_sanity():
    """Train flops ~= 4x forward; decode flops tiny vs prefill."""
    cfg = configs.get("llama3.2-1b")
    train = analytic.step_cost(cfg, ShapeConfig("t", 4096, 256, "train"),
                               n_devices=256, n_microbatches=1)
    pre = analytic.step_cost(cfg, ShapeConfig("p", 4096, 256, "prefill"),
                             n_devices=256)
    dec = analytic.step_cost(cfg, ShapeConfig("d", 4096, 256, "decode"),
                             n_devices=256)
    assert train.flops == pytest.approx(4 * pre.flops, rel=0.01)
    assert dec.flops < pre.flops / 100
    assert train.model_flops == pytest.approx(
        6 * cfg.n_active_params() * 256 * 4096, rel=1e-6)


def test_analytic_flops_matches_flop_counter_single_layer():
    """The reference holds its analytic count against XLA's cost analysis
    of the compiled forward; the port holds it against the FLOPs PyTorch
    counts over the forward it runs (same 1-layer llama, B 4, S 256)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(
        configs.get_smoke("llama3.2-1b"), n_layers=1, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=2048)
    B, S = 4, 256
    batch = make_batch(cfg, "train", B, S, np.random.default_rng(0),
                       device="cpu")
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        transformer.forward(cfg, params, batch, remat=False)
    counted = counter.get_total_flops()
    ratio = analytic.forward_flops(cfg, B, S) / counted
    assert 0.7 < ratio < 1.4, f"analytic/counted flops ratio {ratio:.2f}"


def test_stage_cost_from_model_smoke():
    cfg = configs.get("llama3.2-1b")
    shape = next(s for s in SHAPES.values() if s.kind == "train")
    cost = StageCost.from_model(cfg, shape, n_devices=256)
    assert cost.flops > 0 and cost.hbm_bytes > 0


@pytest.mark.parametrize("arch", configs.names())
def test_stage_cost_from_model_equals_reference(arch):
    cfg, jcfg = _pairs(arch)
    for kw in MESHES.values():
        got = StageCost.from_model(cfg, SHAPES["train_4k"], **kw)
        want = JStageCost.from_model(jcfg, JSHAPES["train_4k"], **kw)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)


def test_session_places_a_model_stage_by_its_cost():
    """A train stage priced by ``from_model`` is compute-bound, so the
    placer sends it to the pilot advertising more FLOP/s, and records the
    estimate beside the stage's actual runtime."""
    cfg = configs.get("hymba-1.5b")
    cost = StageCost.from_model(cfg, ShapeConfig("t", 2048, 8, "train"),
                                n_devices=1, tp=1, n_microbatches=2)
    s = Session(ResourceManager(devices=[torch.device("cpu")] * 2),
                cost_model=TransferCostModel(dcn_cost_per_byte=0.0))
    try:
        s.add_pilot(PilotDescription(
            n_chips=1, name="slow", runtime="hpc",
            peak_flops_per_chip=100e12, hbm_bw_per_chip=3.35e12))
        s.add_pilot(PilotDescription(
            n_chips=1, name="fast", runtime="hpc",
            peak_flops_per_chip=989e12, hbm_bw_per_chip=3.35e12))
        s.run([hpc_stage("train", lambda mesh=None: {}, cost=cost)])
        place = s.placements["train"]
        assert place["pilot"] == "fast"
        assert place["chosen"]["bound"] == "compute"
        assert place["est_runtime_s"] == pytest.approx(cost.flops / 989e12)
        assert place["actual_runtime_s"] >= 0
        assert place["est_error_ratio"] == pytest.approx(
            place["actual_runtime_s"] / place["est_runtime_s"])
    finally:
        s.shutdown()
