"""Each cell's control fails its check: on the card, at the cell's own
size, the reference computed one precision below the configuration's
(TF32 for K-Means' float32 with TF32 off, float8 for Hymba's bf16) and
put in the program's place reads over a limit, where the program's own
run of the same seed reads under every limit.  Skips without a card."""
from __future__ import annotations

import pytest

from bench_support import BENCH, ROOT, card, load, with_kept  # noqa: F401

CASES = [("kmeans-fig6.mode1-local", "tf32", 8.0, 7001),
         ("hymba-1.5b.train-8x2048", "fp8", 0.1, 7002),
         ("hymba-1.5b.train-8x2048", "half", 0.1, 7003)]


@pytest.mark.parametrize("cell, kind, seconds, seed", CASES)
def test_control_fails_where_the_program_passes(card, cell, kind, seconds,
                                                seed):
    from lib import harness
    got = {}
    res = harness.execute(cell, seed, seconds, False, device=card,
                          spec=with_kept(load(ROOT / "BENCHMARK.json")),
                          log=lambda *_: None,
                          after=lambda run, drv: got.update(
                              drv.control(run, kind)))
    assert res["correct"], res["checks"]
    limits = load(BENCH / "workloads" / f"{cell}.json")["limits"]
    assert any(got[k] > limits[k] for k in got), (got, limits)
