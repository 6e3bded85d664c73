"""Parity of the port's Session layer with the JAX reference.

The cases of tests/test_session.py (all but the multi-pilot trainer,
which waits for the training slice), tests/test_roofline_placement.py
(``StageCost.from_model``'s case is in test_torch_analytic.py) and
the Session cases of tests/test_elastic.py, tests/test_fairshare.py and
tests/test_staging.py run on both packages: the reference on the CPU's
JAX devices, the port on ``[torch.device("cpu")] * n``.  Placement
decisions are compared by pilot *name* (uids come from a process
counter) and without wall-clock fields.  The Fig-8 sweep of
benchmarks/bench_session_placement.py feeds the reference's dataset to
both packages and compares every decision by equality.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.analytics import kmeans as jkm
from repro.analytics.engine import AnalyticsEngine as JEngine
from repro.compat import make_mesh
from repro.core.dataplane import replicated_sharding as jrep

import repro_torch.core as tcore
from repro_torch import convert
from repro_torch.analytics import kmeans as tkm
from repro_torch.analytics.engine import AnalyticsEngine as TEngine
from repro_torch.core import (ComputeUnitDescription, DataPlane, DeviceGrid,
                              GFS_ARCHIVE, Lineage, Link, PilotDescription,
                              ResourceManager, Session, YarnStyleScheduler,
                              analytics_stage, hpc_stage, place,
                              replicated_sharding)
from repro_torch.core.compute_unit import ComputeUnit

CPU = torch.device("cpu")
TIMEOUT = 60.0
CORE = {"ref": jcore, "port": tcore}


def _devices(pkg, n):
    return jax.devices() * n if pkg == "ref" else [CPU] * n


def _host(pkg, arr):
    return np.asarray(arr) if pkg == "ref" else arr.to_numpy()


def _session(pkg, n_slots, pilots=(), **kw):
    core = CORE[pkg]
    s = core.Session(core.ResourceManager(devices=_devices(pkg, n_slots)),
                     **kw)
    for desc in pilots:
        s.add_pilot(core.PilotDescription(**desc))
    return s


def _reference_draw(pts, k, seed):
    """The reference's centroid draw (kmeans.py:59-61), fed to the port."""
    idx = np.asarray(jax.random.choice(jax.random.key(seed), pts.shape[0],
                                       (k,), replace=False))
    return pts.full()[torch.from_numpy(idx.astype(np.int64))]


@pytest.fixture
def same_draw(monkeypatch):
    monkeypatch.setattr(tkm, "_init_centroids", _reference_draw)


WALL_CLOCK = {"pilot_uid", "mode1_spawn_s", "actual_runtime_s",
              "est_error_ratio"}


def _decision(place):
    """A placement decision without uids and wall-clock fields."""
    return {k: v for k, v in place.items() if k not in WALL_CLOCK}


# ---------------------------------------------- tests/test_session.py
TWO_PILOTS = ({"n_chips": 1, "name": "hpc", "runtime": "hpc"},
              {"n_chips": 1, "name": "ana", "runtime": "analytics"})


def _dag(pkg):
    km = jkm if pkg == "ref" else tkm

    def simulate(mesh=None):
        rng = np.random.default_rng(0)
        return {"traj": rng.normal(size=(64, 4)).astype(np.float32)}

    def analyze(engine=None, traj=None):
        centroids, cost = km.kmeans_fit(engine, "traj", 4, iters=2)
        return {"centroids": centroids, "cost": cost}

    def train(centroids=None, results=None, mesh=None):
        assert np.isfinite(results["analyze"]["cost"])
        return float(centroids.sum())

    return [
        hpc_stage("simulate", simulate, outputs=("traj",)),
        analytics_stage("analyze", analyze, inputs=("traj",),
                        outputs=("centroids",)),
        hpc_stage("train", train, inputs=("centroids",), after=("analyze",)),
    ]


def _run_dag(pkg, dcn_cost):
    s = _session(pkg, 2, TWO_PILOTS, cost_model=CORE[pkg].TransferCostModel(
        dcn_cost_per_byte=dcn_cost))
    try:
        results = s.run(_dag(pkg), timeout=TIMEOUT)
        return {"results": results,
                "placements": {n: _decision(p)
                               for n, p in s.placements.items()},
                "ledger": s.dataplane.ledger(),
                "names": sorted(s.dataplane.names()),
                "traj": _host(pkg, s.dataplane.get("traj").array)}
    finally:
        s.shutdown()


@pytest.mark.parametrize("dcn_cost", [0.0, 1.0])
def test_session_dag_matches_reference(same_draw, dcn_cost):
    """simulate -> analyze -> train over two pilots: the same placement
    decisions (every term), the same ledger byte for byte, and the same
    results."""
    ref, out = _run_dag("ref", dcn_cost), _run_dag("port", dcn_cost)
    assert out["placements"] == ref["placements"]
    assert out["ledger"] == ref["ledger"]
    assert out["names"] == ref["names"] == ["centroids", "traj"]
    np.testing.assert_array_equal(out["traj"], ref["traj"])
    assert out["results"]["analyze"]["cost"] == pytest.approx(
        ref["results"]["analyze"]["cost"], rel=1e-5)
    assert out["results"]["train"] == pytest.approx(ref["results"]["train"],
                                                    rel=1e-5)


def test_session_dag_executes_across_pilots():
    out = _run_dag("port", 0.0)
    assert set(out["results"]) == {"simulate", "analyze", "train"}
    assert np.isfinite(out["results"]["train"])
    assert set(out["placements"]) == {"simulate", "analyze", "train"}
    assert out["placements"]["simulate"]["pilot"] == "hpc"
    assert out["placements"]["train"]["pilot"] == "hpc"


def test_high_movement_cost_runs_where_data_lives():
    out = _run_dag("port", 1.0)
    place = out["placements"]["analyze"]
    assert (place["pilot"], place["mode"]) == ("hpc", "mode1-carve")
    assert out["ledger"]["by_link"][Link.DCN] == 0


def test_zero_movement_cost_consolidates():
    out = _run_dag("port", 0.0)
    place = out["placements"]["analyze"]
    assert (place["pilot"], place["mode"]) == ("ana", "native")
    assert out["ledger"]["by_link"][Link.DCN] > 0
    assert place["dcn_bytes_moved"] == 64 * 4 * 4


def test_stage_tensors_live_on_the_pilots_own_device_object():
    """Published outputs carry the pool's device objects (identity), and
    a stage input arrives as a tensor."""
    s = _session("port", 2, TWO_PILOTS)
    seen = {}
    try:
        def produce(mesh=None):
            return {"x": torch.arange(6, dtype=torch.float32)}

        def consume(x=None, mesh=None):
            seen["x"] = x
            return float(x.sum())

        out = s.run([hpc_stage("p", produce, outputs=("x",)),
                     hpc_stage("c", consume, inputs=("x",))],
                    timeout=TIMEOUT)
        assert out["c"] == 15.0
        assert isinstance(seen["x"], torch.Tensor)
        hpc = s.pilots["hpc"]
        placement = s.dataplane.get("x").array.placement
        assert placement.devices[0] is hpc.devices[0]
    finally:
        s.shutdown()


def test_stage_errors_reach_run():
    s = _session("port", 2, TWO_PILOTS)
    try:
        def boom(mesh=None):
            raise ZeroDivisionError("stage body failed")

        with pytest.raises(RuntimeError, match="stage body failed"):
            s.run([hpc_stage("bad", boom)], timeout=TIMEOUT)
        with pytest.raises(ValueError, match="did not return"):
            s.run([hpc_stage("quiet", lambda mesh=None: {},
                             outputs=("y",))], timeout=TIMEOUT)
    finally:
        s.shutdown()


def _ledger_ops(data, rm):
    data.record_moved(100, rm.DCN, "x")
    data.record_moved(50, rm.GFS, "y")
    data.record_moved(25, rm.ICI)
    return data.moved_bytes, data.moved_by_link(rm.DCN), data.ledger()


def test_record_moved_public_ledger():
    ref = _ledger_ops(jcore.DataPlane(), jcore.Link)
    out = _ledger_ops(DataPlane(), Link)
    assert out == ref
    assert out[0] == 175 and out[2]["by_reason"]["x"] == 100
    with pytest.raises(ValueError):
        DataPlane().record_moved(1, "carrier-pigeon")


def test_global_reshard_routes_through_ledger():
    x = np.ones((32, 4), np.float32)
    jeng = JEngine(make_mesh((1, 1), ("data", "model")), jcore.DataPlane())
    jeng.put("d", x)
    jeng.global_reshard("d")
    teng = TEngine(DeviceGrid([CPU]), DataPlane())
    teng.put("d", x)
    teng.global_reshard("d")
    assert teng.data.ledger() == jeng.data.ledger()
    assert teng.data.moved_by_link(Link.GFS) == 2 * x.nbytes
    assert teng.data.ledger()["by_reason"]["gfs-spool-write"] == x.nbytes


def test_replica_tracking_and_lineage():
    def run(core, arr):
        dp = core.DataPlane()
        dp.put("a", arr, pilot="p0", lineage=core.Lineage("prod", ("x",)))
        out = [dp.home_pilots("a"), dp.resident_on("a", "p0"),
               dp.resident_on("a", "p1"), dp.pilot_locality(["a"], "p0"),
               dp.bytes_nonresident(["a"], "p1")]
        dp.add_replica("a", "p1")
        out += [dp.bytes_nonresident(["a"], "p1"),
                dp.drop_pilot_replicas("p0"), dp.drop_pilot_replicas("p1"),
                dp.lineage_of("a").stage]
        return out

    ref = run(jcore, jnp.ones((8,)))
    out = run(tcore, place(np.ones(8, np.float32), replicated_sharding([CPU])))
    assert out == ref
    assert out == [{"p0"}, True, False, 1.0, 32, 0, [], ["a"], "prod"]


def _rematerialize(pkg):
    s = _session(pkg, 2, TWO_PILOTS, cost_model=CORE[pkg].TransferCostModel(
        dcn_cost_per_byte=1.0))
    try:
        s.run(_dag(pkg), timeout=TIMEOUT)
        before = _host(pkg, s.dataplane.get("traj").array)
        lost = s.dataplane.drop_pilot_replicas(s.pilots["hpc"].uid)
        s.rematerialize("traj", timeout=TIMEOUT)
        homes = {p.desc.name for p in s.pilots.values()
                 if p.uid in s.dataplane.home_pilots("traj")}
        return (before, _host(pkg, s.dataplane.get("traj").array), lost,
                homes)
    finally:
        s.shutdown()


def test_session_rematerializes_lost_output(same_draw):
    ref, out = _rematerialize("ref"), _rematerialize("port")
    assert "traj" in out[2] and sorted(out[2]) == sorted(ref[2])
    assert out[3] == ref[3] == {"hpc"}
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_array_equal(out[1], ref[1])


def test_dag_cycle_detection():
    s = _session("port", 2, TWO_PILOTS)
    try:
        dag = [hpc_stage("a", lambda mesh=None: None, inputs=("y",),
                         outputs=("x",)),
               hpc_stage("b", lambda mesh=None: None, inputs=("x",),
                         outputs=("y",))]
        with pytest.raises(ValueError, match="cycle"):
            s.run(dag)
        with pytest.raises(ValueError, match="unknown stage"):
            s.run([hpc_stage("c", lambda mesh=None: 1, after=("nope",))])
    finally:
        s.shutdown()


class FakeDevice:
    def __init__(self, i):
        self.i = i
        self.type = self.platform = "fake"


class FakeData:
    """Registry entry pinned to an explicit device subset."""

    def __init__(self, devices, nbytes=1024):
        self._devices = set(devices)
        self.nbytes = nbytes

    def device_set(self):
        return set(self._devices)

    def locality(self, devices):
        return len(self._devices & set(devices)) / len(self._devices)


def test_scheduler_finds_noncontiguous_local_placement():
    devs = [FakeDevice(i) for i in range(4)]
    dp = DataPlane()
    dp._data["ds"] = FakeData({devs[0], devs[2]})
    sched = YarnStyleScheduler(devs, 16, dp, locality_delay_rounds=3)
    cu = ComputeUnit(ComputeUnitDescription(
        fn=lambda: None, n_chips=2, data=("ds",)))
    sched.submit(cu)
    bound = sched.try_schedule()
    assert len(bound) == 1
    assert sorted(bound[0][1]) == [0, 2]
    assert sched.stats["locality_hits"] == 1
    assert sched.stats["locality_misses"] == 0


def test_scheduler_skip_counts_cleaned_up():
    devs = [FakeDevice(i) for i in range(2)]
    dp = DataPlane()
    dp._data["ds"] = FakeData({FakeDevice(99)})
    sched = YarnStyleScheduler(devs, 16, dp, locality_delay_rounds=2)
    cu = ComputeUnit(ComputeUnitDescription(
        fn=lambda: None, n_chips=1, data=("ds",)))
    sched.submit(cu)
    bound = []
    for _ in range(5):
        bound += sched.try_schedule()
    assert len(bound) == 1
    assert sched.stats["locality_misses"] == 1
    assert cu.uid not in sched._skip_counts


# ------------------------------------- tests/test_roofline_placement.py
BIGFLOPS = {"peak_flops_per_chip": 100e12, "hbm_bw_per_chip": 100e9}
BIGMEM = {"peak_flops_per_chip": 10e12, "hbm_bw_per_chip": 1000e9}
ROOFLINE_PILOTS = ({"n_chips": 1, "name": "bigflops", "runtime": "hpc",
                    **BIGFLOPS},
                   {"n_chips": 1, "name": "bigmem", "runtime": "hpc",
                    **BIGMEM})


def _noop(**kw):
    return {}


def _roofline_run(pkg, costs, runs=1, **kw):
    """Each run places the stages {name: (flops, hbm)}; returns the
    decisions and the chosen pilots' heartbeat roofline records."""
    core = CORE[pkg]
    s = _session(pkg, 2, ROOFLINE_PILOTS, cost_model=core.TransferCostModel(
        dcn_cost_per_byte=0.0), **kw)
    try:
        for r in range(runs):
            s.run([hpc_stage(f"{name}{r or ''}", _noop,
                             cost=core.StageCost(*c) if c else None)
                   for name, c in costs.items()], timeout=TIMEOUT)
        beats = {n: s.pilots[n].agent.heartbeat()["roofline"]["n"]
                 for n in s.pilots}
        drift = {v["name"]: v["est_drift"] is not None
                 for v in s.control_plane.poll().values()}
        return ({n: _decision(p) for n, p in s.placements.items()},
                dict(s.placements), beats, drift,
                {n: s.pilots[n].agent.heartbeat()["roofline"]
                 for n in s.pilots})
    finally:
        s.shutdown()


def _chosen(decisions):
    """Decisions without the calibration ratio (an EMA of wall clocks)."""
    out = {}
    for n, d in decisions.items():
        d = {k: v for k, v in d.items() if k != "est_runtime_s"}
        d["chosen"] = {k: v for k, v in d["chosen"].items()
                       if k not in ("calibration_ratio", "est_runtime",
                                    "total")}
        d["scores"] = {p: {k: v for k, v in sc.items()
                           if k not in ("calibration_ratio", "est_runtime",
                                        "total")}
                       for p, sc in d["scores"].items()}
        out[n] = d
    return out


@pytest.mark.parametrize("costs,want", [
    ({"c": (1000e12, 10e9)}, {"c": ("bigflops", "compute")}),
    ({"m": (10e12, 2000e9)}, {"m": ("bigmem", "memory")}),
    ({"plain": None}, {"plain": ("bigflops", None)}),
], ids=["compute-bound", "memory-bound", "no-cost"])
def test_roofline_placement_matches_reference(costs, want):
    ref, out = _roofline_run("ref", costs), _roofline_run("port", costs)
    assert out[0] == ref[0]
    assert out[2] == ref[2] and out[3] == ref[3]
    for name, (pilot, bound) in want.items():
        assert out[0][name]["pilot"] == pilot
        assert out[0][name]["chosen"].get("bound") == bound
        assert ("est_runtime" in out[0][name]["chosen"]) == bool(bound)


def test_roofline_off_ignores_cost():
    costs = {"c": (1000e12, 10e9), "m": (10e12, 1000e9)}
    ref = _roofline_run("ref", costs, roofline_placement=False)
    out = _roofline_run("port", costs, roofline_placement=False)
    assert out[0] == ref[0]
    assert out[0]["c"]["pilot"] == out[0]["m"]["pilot"]
    assert "est_runtime" not in out[0]["c"]["chosen"]


def test_estimate_error_recorded_and_exported():
    decisions, raw, beats, drift, rf = _roofline_run(
        "port", {"c": (1000e12, 10e9)})
    place = raw["c"]
    assert place["est_runtime_s"] > 0
    assert place["actual_runtime_s"] >= 0
    assert place["est_error_ratio"] > 0
    hb = rf[place["pilot"]]
    assert hb["n"] == 1
    assert hb["ema_error_ratio"] == pytest.approx(place["est_error_ratio"])
    assert hb["last"]["tag"] == "stage:c"
    assert drift[place["pilot"]]


def test_calibration_opt_in():
    cost = {"first": (1000e12, 10e9)}
    ref = _roofline_run("ref", cost, runs=2, calibrate_estimates=True)
    out = _roofline_run("port", cost, runs=2, calibrate_estimates=True)
    assert _chosen(out[0]) == _chosen(ref[0])
    chosen = out[1]["first1"]["chosen"]
    assert chosen["calibration_ratio"] > 0
    assert "calibration_ratio" not in out[1]["first"]["chosen"]


def test_pilot_description_advertises_roofline_defaults():
    d = PilotDescription(n_chips=1, name="p")
    assert d.peak_flops_per_chip == pytest.approx(989e12)   # H100 SXM
    assert d.hbm_bw_per_chip == pytest.approx(3.35e12)


# -------------------------- benchmarks/bench_session_placement.py (Fig 8)
DCN_COSTS = (0.0, 1e-9, 1e-7, 1e-5, 1e-3, 1.0)
N_POINTS = (1024, 16384)
K = 8


def _fig8_row(pkg, dcn_cost, pts):
    km = jkm if pkg == "ref" else tkm
    core = CORE[pkg]
    s = _session(pkg, 2, TWO_PILOTS, cost_model=core.TransferCostModel(
        dcn_cost_per_byte=dcn_cost))
    try:
        def simulate(mesh=None):
            return {"pts": pts}

        def analyze(engine=None, pts=None):
            return {"cost": km.kmeans_fit(engine, "pts", K, iters=2)[1]}

        res = s.run([hpc_stage("simulate", simulate, outputs=("pts",)),
                     analytics_stage("analyze", analyze, inputs=("pts",))],
                    timeout=TIMEOUT)
        place = s.placements["analyze"]
        return ({"placed_on": place["pilot"], "mode": place["mode"],
                 "dcn_bytes": s.dataplane.moved_by_link(Link.DCN),
                 "ici_bytes": s.dataplane.moved_by_link(Link.ICI),
                 "score_hpc": place["scores"]["hpc"]["total"],
                 "score_ana": place["scores"]["ana"]["total"]},
                res["analyze"]["cost"])
    finally:
        s.shutdown()


@pytest.mark.parametrize("n_points", N_POINTS)
def test_fig8_sweep_matches_reference(same_draw, n_points):
    pts = np.asarray(jkm.make_dataset(n_points, 4, n_clusters=K, seed=0),
                     np.float32)
    modes = []
    for dcn_cost in DCN_COSTS:
        ref_row, ref_cost = _fig8_row("ref", dcn_cost, pts)
        row, cost = _fig8_row("port", dcn_cost, pts)
        assert row == ref_row, dcn_cost
        assert cost == pytest.approx(ref_cost, rel=1e-5)
        modes.append(row["mode"])
    # the two ends of the crossover, and at most one change along it
    assert modes[0] == "native" and modes[-1] == "mode1-carve"
    assert sum(a != b for a, b in zip(modes, modes[1:])) == 1


# ------------------------------------------- tests/test_elastic.py:380, 402
def test_session_unplaceable_stage_requests_rebalance():
    s = _session("port", 4, (
        {"n_chips": 2, "name": "a", "runtime": "hpc",
         "enable_speculation": False},
        {"n_chips": 2, "name": "b", "runtime": "hpc",
         "enable_speculation": False}))
    try:
        out = s.run([hpc_stage(
            "wide", lambda mesh=None: len(mesh.devices.flat), n_chips=3)],
            timeout=TIMEOUT)
        assert out["wide"] == 3
        place = s.placements["wide"]
        assert place.get("rebalanced_chips", 0) >= 1
        assert len(s.pilots[place["pilot"]].devices) >= 3
        assert len(s.pm.control_plane.events) >= 1
    finally:
        s.shutdown()


def test_drain_keeps_lineage_rematerialization_working():
    s = _session("port", 4, (
        {"n_chips": 2, "name": "hpc", "runtime": "hpc",
         "enable_speculation": False},
        {"n_chips": 2, "name": "ana", "runtime": "analytics",
         "enable_speculation": False}))
    try:
        def simulate(mesh=None):
            return {"traj": np.arange(32, dtype=np.float32)}

        s.run([hpc_stage("simulate", simulate, outputs=("traj",))],
              timeout=TIMEOUT)
        hpc, ana = s.pilots["hpc"], s.pilots["ana"]
        assert s.pm.control_plane.move(hpc, ana, 1, reason="test") is not None
        assert "traj" in s.dataplane
        assert "traj" in s.dataplane.drop_pilot_replicas(hpc.uid)
        s.rematerialize("traj", timeout=TIMEOUT)
        np.testing.assert_array_equal(s.dataplane.get("traj").array.to_numpy(),
                                      np.arange(32, dtype=np.float32))
    finally:
        s.shutdown()


# ----------------------------------------- tests/test_fairshare.py:446, 534
def test_session_tenant_context_tags_and_limits_stages():
    s = _session("port", 4, ({"n_chips": 4, "name": "p", "runtime": "hpc",
                              "enable_speculation": False},))
    try:
        alice = s.tenant("alice", max_concurrent_stages=1)
        live, peak = [0], [0]
        gate = threading.Lock()

        def work(mesh=None):
            with gate:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.05)
            with gate:
                live[0] -= 1
            return 1

        out = alice.run([hpc_stage(f"s{i}", work, n_chips=1, gang=False)
                         for i in range(3)], timeout=TIMEOUT)
        assert sum(out.values()) == 3
        assert peak[0] == 1
        assert alice.stats == {"submitted": 3, "completed": 3}
        for i in range(3):
            assert s.placements[f"s{i}"]["tenant"] == "alice"
        assert s.pilots["p"].agent.scheduler.queues.get("alice") is not None
        assert s.tenant("alice") is alice
    finally:
        s.shutdown()


def test_session_tenant_reregistration_conflict_raises():
    s = Session(ResourceManager(devices=[CPU]))
    try:
        s.tenant("a", max_concurrent_stages=2)
        assert s.tenant("a") is s.tenant("a")
        assert s.tenant("a", max_concurrent_stages=2)
        with pytest.raises(ValueError, match="already registered"):
            s.tenant("a", max_concurrent_stages=5)
        with pytest.raises(ValueError, match="already registered"):
            s.tenant("a", queue="gold")
        with pytest.raises(ValueError, match=">= 1"):
            s.tenant("b", max_concurrent_stages=0)
    finally:
        s.shutdown()


# ------------------------------------------ tests/test_staging.py:281, 318
def _prefetch_dag(pkg):
    core = CORE[pkg]
    s = _session(pkg, 4, (), prefetch=True)
    src = s.add_pilot(core.PilotDescription(n_chips=2, name="src",
                                            enable_speculation=False))
    wrk = s.add_pilot(core.PilotDescription(n_chips=2, name="wrk",
                                            enable_speculation=False,
                                            staging_delay_rounds=500))
    try:
        if pkg == "ref":
            x = jax.device_put(jnp.ones((2048,), jnp.float32),
                               jrep(src.devices))
        else:
            x = place(np.ones(2048, np.float32),
                      replicated_sharding(src.devices))
        s.dataplane.put("x", x, pilot=src.uid)

        def work(x=None, mesh=None):
            return float(x.sum())

        out = s.run([
            hpc_stage("a", work, inputs=("x",), pilot="wrk", n_chips=1),
            hpc_stage("b", work, inputs=("x",), pilot="wrk", n_chips=1,
                      after=("a",)),
        ], timeout=TIMEOUT)
        return (out, s.dataplane.resident_on("x", wrk.uid),
                s.dataplane.resident_on("x", src.uid),
                s.dataplane.moved_by_link(Link.DCN), x.nbytes,
                wrk.prefetcher.cache.stats["hits"],
                s.placements["a"]["pre_staged"],
                s.placements["a"]["dcn_bytes_moved"]
                + s.placements["b"]["dcn_bytes_moved"])
    finally:
        s.shutdown()


def test_session_prefetch_dag_end_to_end():
    ref, out = _prefetch_dag("ref"), _prefetch_dag("port")
    assert out == ref
    res, on_wrk, on_src, dcn, nbytes, hits, pre, moved = out
    assert res["a"] == res["b"] == 2048.0
    assert on_wrk and on_src
    assert dcn == nbytes == moved
    assert hits >= 1 and pre


def test_session_stage_out_archives_output():
    s = _session("port", 2, ({"n_chips": 1, "name": "hpc",
                              "enable_speculation": False},), prefetch=True)
    try:
        def produce(mesh=None):
            return torch.ones(128)

        s.run([hpc_stage("p", produce, outputs=("y",), stage_out=("y",))],
              timeout=TIMEOUT)
        deadline = time.monotonic() + 10
        while (not s.dataplane.resident_on("y", GFS_ARCHIVE)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert s.dataplane.resident_on("y", GFS_ARCHIVE)
        assert s.dataplane.moved_by_link(Link.GFS) == \
            s.dataplane.get("y").nbytes == 512
    finally:
        s.shutdown()


def test_stage_outputs_accept_numpy_bf16_and_python_numbers():
    import ml_dtypes
    s = _session("port", 1, ({"n_chips": 1, "name": "hpc"},))
    try:
        half = np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16)

        def produce(mesh=None):
            return {"h": half, "f": 2.5, "t": torch.ones(3, 2)}

        s.run([hpc_stage("p", produce, outputs=("h", "f", "t"))],
              timeout=TIMEOUT)
        got = convert.state_to_numpy(s.dataplane)
        assert got["h"].dtype == half.dtype
        np.testing.assert_array_equal(got["h"], half)
        assert got["f"].shape == () and got["f"].dtype == np.float32
        assert float(got["f"]) == 2.5
        assert got["t"].shape == (3, 2)
        assert s.dataplane.lineage_of("t") == Lineage("p", ())
    finally:
        s.shutdown()
