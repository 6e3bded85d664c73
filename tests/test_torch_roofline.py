"""Parity of the port's roofline terms and stage-cost model with the JAX
reference: the same inputs (and the same explicit ``HW``) give equal
results."""
import dataclasses

import numpy as np
import pytest

from repro.roofline import placement as jplace
from repro.roofline import terms as jterms

from repro_torch import roofline
from repro_torch.roofline import placement as tplace
from repro_torch.roofline import terms as tterms


def _costs(seed=0, n=40):
    rng = np.random.default_rng(seed)
    flops = 10.0 ** rng.uniform(0, 18, n)
    hbm = 10.0 ** rng.uniform(0, 15, n)
    return list(zip(flops.tolist(), hbm.tolist()))


@pytest.mark.parametrize("n_chips", [0, 1, 3, 8])
@pytest.mark.parametrize("peak,bw", [(197e12, 819e9), (989e12, 3.35e12),
                                     (1e12, 1e9), (0.0, 0.0)])
def test_est_runtime_matches_reference(n_chips, peak, bw):
    for flops, hbm in _costs():
        args = {"n_chips": n_chips, "peak_flops": peak, "hbm_bw": bw}
        assert tplace.est_runtime(tplace.StageCost(flops, hbm), **args) == \
            jplace.est_runtime(jplace.StageCost(flops, hbm), **args)


def test_est_runtime_bound_selection():
    compute = tplace.est_runtime(tplace.StageCost(flops=1e15, hbm_bytes=1.0),
                                 n_chips=1, peak_flops=1e12, hbm_bw=1e9)
    assert compute["bound"] == "compute"
    assert compute["est_s"] == pytest.approx(1e3)
    memory = tplace.est_runtime(tplace.StageCost(flops=1.0, hbm_bytes=1e12),
                                n_chips=1, peak_flops=1e12, hbm_bw=1e9)
    assert memory["bound"] == "memory"
    assert memory["est_s"] == pytest.approx(1e3)
    half = tplace.est_runtime(tplace.StageCost(flops=1e15, hbm_bytes=1.0),
                              n_chips=2, peak_flops=1e12, hbm_bw=1e9)
    assert half["est_s"] == pytest.approx(500.0)


@pytest.mark.parametrize("flops,hbm", [(-1.0, 0.0), (0.0, -1.0)])
def test_stage_cost_validates_as_reference(flops, hbm):
    with pytest.raises(ValueError) as want:
        jplace.StageCost(flops=flops, hbm_bytes=hbm)
    with pytest.raises(ValueError) as got:
        tplace.StageCost(flops=flops, hbm_bytes=hbm)
    assert str(got.value) == str(want.value)


def test_stage_cost_fields_and_intensity_match_reference():
    assert [f.name for f in dataclasses.fields(tplace.StageCost)] == \
        [f.name for f in dataclasses.fields(jplace.StageCost)]
    for flops, hbm in _costs(1) + [(5.0, 0.0), (0.0, 0.0)]:
        assert tplace.StageCost(flops, hbm).intensity == \
            jplace.StageCost(flops, hbm).intensity
    assert tplace.StageCost(100.0, 10.0).intensity == pytest.approx(10.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tplace.StageCost(1.0, 1.0).flops = 2.0


@pytest.mark.parametrize("est,actual", [(2.0, 4.0), (0.0, 4.0), (-1.0, 1.0),
                                        (1e-9, 3.0), (5.0, 0.0)])
def test_estimate_error_matches_reference(est, actual):
    assert tplace.estimate_error(est, actual) == \
        jplace.estimate_error(est, actual)


def test_hw_is_the_h100_data_sheet():
    hw = tterms.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989e12, 3.35e12, 450e9)
    assert [f.name for f in dataclasses.fields(tterms.HW)] == \
        [f.name for f in dataclasses.fields(jterms.HW)]


@pytest.mark.parametrize("hw", [tterms.HW(), jterms.HW(),
                                tterms.HW(1e12, 1e9, 1e8)],
                         ids=["h100", "reference-default", "small"])
@pytest.mark.parametrize("n_chips", [1, 4, 256])
def test_roofline_terms_match_reference_given_the_same_hw(hw, n_chips):
    rng = np.random.default_rng(n_chips)
    for _ in range(20):
        flops, hbm, coll, model = (10.0 ** rng.uniform(0, 18, 4)).tolist()
        kw = {"flops_global": flops, "hbm_bytes_global": hbm,
              "collective_bytes_per_device": coll, "n_chips": n_chips,
              "model_flops": model}
        want = jterms.roofline_terms(**kw, hw=jterms.HW(**dataclasses.asdict(
            hw)))
        got = tterms.roofline_terms(**kw, hw=tterms.HW(**dataclasses.asdict(
            hw)))
        assert got == want


def test_roofline_terms_default_to_the_h100():
    kw = {"flops_global": 989e12, "hbm_bytes_global": 3.35e12 / 2,
          "collective_bytes_per_device": 450e9 / 4, "n_chips": 1,
          "model_flops": 989e12 / 2}
    got = tterms.roofline_terms(**kw)
    assert got["compute_s"] == pytest.approx(1.0)
    assert got["memory_s"] == pytest.approx(0.5)
    assert got["collective_s"] == pytest.approx(0.25)
    assert got["dominant"] == "compute"
    assert got["useful_flop_ratio"] == pytest.approx(0.5)
    assert got["roofline_fraction"] == pytest.approx(0.5)


def test_package_exports_terms_and_placement_only():
    """The name is historical: the package exported only the terms and
    the placer until the collective counter and ``from_model`` were
    ported.  It exports the reference's names, and importing it does
    not load the analytic model (``from_model`` imports it when
    called)."""
    assert {n for n in vars(roofline) if not n.startswith("_")} >= {
        "HW", "roofline_terms", "StageCost", "est_runtime", "estimate_error",
        "terms", "placement", "collectives", "collective_bytes_per_device"}
    assert callable(roofline.collective_bytes_per_device)
    assert hasattr(tplace.StageCost, "from_model") \
        and hasattr(jplace.StageCost, "from_model")
