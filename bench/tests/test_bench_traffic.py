"""The traffic and the inputs are a function of the seed: the same seed
gives the same, another seed another, and every seed of a serving mix
offers the same work in another order."""
from __future__ import annotations

import types

import pytest
import torch

from bench_support import BENCH, ROOT, SERVE_CELL, load, with_kept

from lib import harness, seeds

SPEC = with_kept(load(ROOT / "BENCHMARK.json"))


def fake_run(cell: str, seed: int, seconds: float = 30.0):
    c = harness.Cell(SPEC, cell)
    return types.SimpleNamespace(cell=c, config=c.config, traffic=c.traffic,
                                 seed=seed, seconds=seconds)


def driver(kind: str):
    return harness.load_module(BENCH / "drivers" / f"{kind}.py",
                               f"t_driver_{kind}")


SEEDS = [3, 2 ** 31 + 11, 5_000_000_017]


@pytest.mark.parametrize("seed", SEEDS)
def test_serving_schedule_same_seed_same_traffic(seed):
    drv = driver("serve_open")
    a = drv.schedule(fake_run(SERVE_CELL, seed))
    b = drv.schedule(fake_run(SERVE_CELL, seed))
    assert a == b
    r = fake_run(SERVE_CELL, seed)
    assert (drv.prompt(r, 5, 300) == drv.prompt(r, 5, 300)).all()


def test_serving_schedule_other_seed_same_work_other_order():
    drv = driver("serve_open")
    a = drv.schedule(fake_run(SERVE_CELL, SEEDS[0]))
    b = drv.schedule(fake_run(SERVE_CELL, SEEDS[1]))
    assert [x["plen"] for x in a] != [x["plen"] for x in b]
    for key in ("plen", "n_out"):
        assert sorted(x[key] for x in a) == sorted(x[key] for x in b)
    gaps = [sorted(round(s[i + 1]["due_in"] - s[i]["due_in"], 9)
                   for i in range(len(s) - 1)) for s in (a, b)]
    assert gaps[0] != gaps[1] or a != b
    r0 = fake_run(SERVE_CELL, SEEDS[0])
    r1 = fake_run(SERVE_CELL, SEEDS[1])
    assert (drv.prompt(r0, 5, 300) != drv.prompt(r1, 5, 300)).any()


def test_serving_schedule_rate_and_lengths():
    drv = driver("serve_open")
    r = fake_run(SERVE_CELL, 9, seconds=40.0)
    s = drv.schedule(r)
    tr = r.traffic
    assert len(s) == round(tr["rate_per_s"] * 40.0)
    assert all(0.0 <= x["due_in"] < 40.0 for x in s)
    assert [x["due_in"] for x in s] == sorted(x["due_in"] for x in s)
    lo, hi = tr["prompt_tokens"]
    assert all(lo <= x["plen"] <= hi for x in s)
    lo, hi = tr["output_tokens"]
    assert all(lo <= x["n_out"] <= hi for x in s)
    assert all(x["plen"] + x["n_out"] <= tr["max_seq"] for x in s)


def test_kmeans_jobs_and_points_follow_the_seed():
    drv = driver("kmeans_pilot")
    r1, r2 = fake_run("kmeans-fig6.mode1-local", 4), \
        fake_run("kmeans-fig6.mode1-local", 5)
    assert drv.jobs(r1, 2, 7) == drv.jobs(r1, 2, 7)
    assert drv.jobs(r1, 2, 7)[0] == drv.jobs(r2, 2, 7)[0]   # same scenario
    assert drv.jobs(r1, 2, 7)[1] != drv.jobs(r2, 2, 7)[1]   # other draw
    mix = r1.config["points"]
    cpu = torch.device("cpu")
    a = drv.make_points(1000, 3, mix, seeds.derive(4, "points", 0), cpu)
    b = drv.make_points(1000, 3, mix, seeds.derive(4, "points", 0), cpu)
    c = drv.make_points(1000, 3, mix, seeds.derive(5, "points", 0), cpu)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_weights_and_batches_follow_the_seed():
    from bench_support import SMOKE_HYMBA
    from reference import hymba, train
    cfg = dict(load(BENCH / "configs" / "hymba-1.5b.json"), **SMOKE_HYMBA)
    cpu = torch.device("cpu")
    a = dict(hymba.leaves(hymba.init_params(cfg, 11, cpu)))
    b = dict(hymba.leaves(hymba.init_params(cfg, 11, cpu)))
    c = dict(hymba.leaves(hymba.init_params(cfg, 12, cpu)))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[("embed",)], c[("embed",)])
    x = train.batch_at(cfg, 2 ** 40 + 3, 0, 8, 64)
    y = train.batch_at(cfg, 2 ** 40 + 3, 0, 8, 64)
    z = train.batch_at(cfg, 2 ** 40 + 3, 1, 8, 64)
    assert (x["tokens"] == y["tokens"]).all()
    assert (x["tokens"] != z["tokens"]).any()
    assert len({r.tobytes() for r in x["tokens"]}) == 8    # rows differ


def test_derived_seeds_take_any_whole_number():
    s = seeds.derive(2 ** 70 + 1, "x")
    assert 0 <= s < 2 ** 63
    assert s != seeds.derive(2 ** 70 + 2, "x")
