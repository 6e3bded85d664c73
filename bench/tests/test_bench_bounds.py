"""The yardstick's arithmetic, pinned to numbers written here: a change
to a bound or a peak shows as a failing test."""
from __future__ import annotations

import pytest

from bench_support import BENCH, load

from lib import bounds

HYMBA = load(BENCH / "configs" / "hymba-1.5b.json")


def test_hymba_parameters_and_training_flops():
    assert bounds.hybrid_params(HYMBA) == 1_661_955_200
    assert HYMBA["parameters"] == 1_661_955_200
    # 6 N tokens at 8 x 2048
    assert bounds.train_flops(HYMBA, 8 * 2048) == 163_376_843_980_800.0
    assert bounds.prefill_flops(HYMBA, 4096) == 2 * 1_661_955_200 * 4096


@pytest.mark.parametrize("n, k, nbytes, by", [
    (10_000, 5_000, 260_000, "operations"),
    (100_000, 500, 2_006_000, "operations"),
    (1_000_000, 50, 20_000_600, "bytes"),
])
def test_assign_bound_at_the_paper_scenarios(n, k, nbytes, by):
    b = bounds.assign_bound(n, k, 3)
    assert b["bytes"] == nbytes and b["flops"] == 400_000_000
    assert b["t_ops"] == pytest.approx(5.970149253731343e-06, rel=1e-12)
    assert b["bound_by"] == by


def test_scan_bounds_at_the_cells_shapes():
    train = bounds.scan_bound(4, 2048, 3200, 16)
    assert (train["bytes"], train["flops"]) == (317_464_576, 2_936_012_800)
    assert train["seconds"] == pytest.approx(9.476554507462686e-05,
                                             rel=1e-12)
    assert train["bound_by"] == "bytes"
    serve = bounds.scan_bound(1, 4096, 3200, 16)
    assert (serve["bytes"], serve["flops"]) == (158_425_088, 1_468_006_400)
    bwd = bounds.ssm_bwd_bound(4, 2048, 3200, 16)
    assert (bwd["bytes"], bwd["flops"]) == (529_252_352, 8_388_608_000)
    assert bwd["seconds"] == pytest.approx(1.579857767164179e-04, rel=1e-12)


def test_peaks():
    assert bounds.FP32_FLOP_PER_S == 67e12
    assert bounds.BF16_TC_FLOP_PER_S == 989e12
    assert bounds.HBM_BYTES_PER_S == 3.35e12
