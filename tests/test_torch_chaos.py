"""Parity of the port's fault-tolerance layer with the JAX reference:
failure injection, heartbeat detection, recovery, and session
checkpoint/resume.

The cases of tests/test_chaos.py run on the port over
``[torch.device("cpu")] * n``.  The seeded injector's kill trace, driven
through ``_tick`` with a fixed ``dt``, equals the reference's kill for
kill.  A session journal written by either package resumes in the
other, with the same completed stages, lineage and arrays.
"""
import json
import os
import pickle
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.analytics import kmeans as tkm
from repro_torch.analytics.engine import AnalyticsEngine
from repro_torch.core import (ComputeUnitDescription, CUState, FailureInjector,
                              KillEvent, PilotDescription, PilotManager,
                              ResourceManager, Session, analytics_stage,
                              hpc_stage)
from repro_torch.core import session as tsession
from repro_torch.core.control_plane import ALIVE, DEAD, SUSPECT

CPU = torch.device("cpu")
CORE = {"ref": jcore, "port": tcore}
TIMEOUT = 60.0


def _devices(pkg, n):
    return jax.devices() * n if pkg == "ref" else [CPU] * n


def _work(dt=0.05, mesh=None):
    time.sleep(dt)
    return "ok"


def _until(cond, what, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@pytest.fixture
def churn_pm():
    """Two 4-slot pilots, detection armed but driven by hand."""
    pm = PilotManager(ResourceManager(devices=[CPU] * 8),
                      heartbeat_timeout_s=0.3, suspect_grace_s=0.3)
    yield pm
    pm.shutdown()


# ----------------------------------------------------------- injection
def _rate_trace(pkg, seed, ticks=150, dt=0.05):
    """Kills of a rate-driven injector over `ticks` fixed ticks: (kind,
    victim name, detail) in order, and the kind counts."""
    core = CORE[pkg]
    pm = core.PilotManager(core.ResourceManager(devices=_devices(pkg, 12)))
    try:
        pilots = [pm.submit(core.PilotDescription(n_chips=3, name=n))
                  for n in "abcd"]
        names = {p.uid: p.desc.name for p in pilots}
        inj = core.FailureInjector(pilots, seed=seed, chip_rate=2.0,
                                   agent_rate=0.4, pilot_rate=0.4)
        for _ in range(ticks):
            assert inj._tick(dt)
        return ([(e.kind, names[e.pilot], e.detail) for e in inj.log],
                inj.counts(), [len(p.devices) for p in pilots])
    finally:
        pm.shutdown()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_injector_trace_equals_reference(seed):
    ref, out = _rate_trace("ref", seed), _rate_trace("port", seed)
    assert out == ref
    kills = out[0]
    assert kills and {k for k, _, _ in kills} >= {"chip"}
    # the blast-radius floor: one pilot is never killed
    whole = [n for k, n, _ in kills if k != "chip"]
    assert len(set(whole)) <= 3


def test_injector_trace_is_deterministic_and_logged():
    pm = PilotManager(ResourceManager(devices=[CPU] * 4))
    try:
        a = pm.submit(PilotDescription(n_chips=2, name="a"))
        b = pm.submit(PilotDescription(n_chips=2, name="b"))
        inj = FailureInjector([a, b], seed=7, trace=[(0.0, "agent", "b")])
        inj.start(tick_s=0.01)
        _until(lambda: inj.log, "the trace never fired")
        inj.stop()
        assert [(e.kind, e.pilot) for e in inj.log] == [("agent", b.uid)]
        assert isinstance(inj.log[0], KillEvent)
        assert b.agent._killed and not a.agent._killed
        assert inj.counts() == {"chip": 0, "agent": 1, "pilot": 0}
        assert not inj.errors
    finally:
        pm.shutdown()


def test_injector_rejects_unknown_kinds_and_names():
    pm = PilotManager(ResourceManager(devices=[CPU] * 4))
    try:
        a = pm.submit(PilotDescription(n_chips=2, name="a"))
        inj = FailureInjector([a], seed=0)
        with pytest.raises(ValueError, match="unknown kill kind"):
            inj._fire("meteor", None)
        with pytest.raises(KeyError, match="no pilot named"):
            inj._fire("agent", "zz")
    finally:
        pm.shutdown()


def test_injector_never_kills_below_min_alive():
    pm = PilotManager(ResourceManager(devices=[CPU] * 2))
    try:
        a = pm.submit(PilotDescription(n_chips=2, name="only"))
        inj = FailureInjector([a], seed=0, min_pilots_alive=1)
        assert inj.kill_pilot() is None
        assert inj.kill_agent(a) is None
        assert a.state.value == "active" and not a.agent._killed
    finally:
        pm.shutdown()


# ----------------------------------------------------------- detection
def test_heartbeat_detection_state_machine(churn_pm):
    pm = churn_pm
    a = pm.submit(PilotDescription(n_chips=4, name="a"))
    b = pm.submit(PilotDescription(n_chips=4, name="b"))
    cp = pm.control_plane
    assert cp.check_failures() == []
    assert cp.liveness_of(b.uid) == ALIVE
    b.agent.kill()
    seen, events = [], []
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not events:
        events = cp.check_failures()
        seen.append(cp.liveness_of(b.uid))
        time.sleep(0.05)
    assert SUSPECT in seen
    assert len(events) == 1 and events[0].pilot == b.uid
    assert cp.liveness_of(b.uid) == DEAD
    assert b.state.value == "failed"
    assert cp.liveness_of(a.uid) == ALIVE
    time.sleep(0.3)
    assert cp.check_failures() == []


def test_suspect_pilot_is_reprieved_by_a_fresh_beat(churn_pm):
    pm = churn_pm
    pm.submit(PilotDescription(n_chips=4, name="a"))
    b = pm.submit(PilotDescription(n_chips=4, name="b"))
    cp = pm.control_plane
    b.agent.last_alive = time.monotonic() - 0.4
    cp.check_failures()
    assert cp.liveness_of(b.uid) == SUSPECT
    b.agent.last_alive = time.monotonic()
    cp.check_failures()
    assert cp.liveness_of(b.uid) == ALIVE


# ------------------------------------------------------------ recovery
def test_recovery_requeues_cus_exactly_once_and_reclaims_lease(churn_pm):
    pm = churn_pm
    a = pm.submit(PilotDescription(n_chips=4, name="a"))
    b = pm.submit(PilotDescription(n_chips=4, name="b"))
    cp = pm.control_plane
    cus = [b.submit(ComputeUnitDescription(
        fn=_work, args=(0.2,), n_chips=1, tag="w")) for _ in range(6)]
    time.sleep(0.05)
    b.kill()
    ev = cp.recover_pilot(b, reason="test")
    assert ev.reclaimed_chips == 4
    assert ev.requeued_cus >= 1 and ev.failed_cus == 0
    assert ev.regranted.get(a.uid) == 4
    assert a.agent.scheduler.n_slots == 8
    assert [cu.follow(timeout=TIMEOUT) for cu in cus] == ["ok"] * 6
    for cu in cus:
        assert cu.state in (CUState.DONE, CUState.CANCELED)
    assert not pm.rm.holdings(b.uid)
    assert ev.recovery_s >= 0


def test_killed_agent_never_publishes_over_the_clone(churn_pm):
    pm = churn_pm
    pm.submit(PilotDescription(n_chips=4, name="a"))
    b = pm.submit(PilotDescription(n_chips=4, name="b"))
    cu = b.submit(ComputeUnitDescription(
        fn=_work, args=(0.6,), n_chips=1, tag="w"))
    time.sleep(0.1)
    b.agent.kill()
    ev = pm.control_plane.recover_pilot(b, reason="test")
    assert ev.requeued_cus == 1
    clone = cu.result
    assert clone is not None and clone.uid != cu.uid
    assert cu.state is CUState.CANCELED
    assert cu.follow(timeout=TIMEOUT) == "ok"
    time.sleep(0.8)
    assert cu.result is clone


def test_lost_last_replica_rematerializes_through_lineage():
    sess = Session(ResourceManager(devices=[CPU] * 8))
    try:
        sess.add_pilot(PilotDescription(n_chips=4, name="a"))
        b = sess.add_pilot(PilotDescription(n_chips=4, name="b"))
        sess.enable_fault_tolerance(heartbeat_timeout_s=0.2)

        def produce(mesh=None):
            return {"D": np.arange(8, dtype=np.float32)}

        sess.run([hpc_stage("make_d", produce, outputs=("D",),
                            pilot="b", n_chips=1)], timeout=TIMEOUT)
        assert sess.dataplane.home_pilots("D") == {b.uid}
        b.kill()
        ev = sess.control_plane.recover_pilot(b, reason="test")
        assert "D" in ev.lost_datasets and ev.rematerialized == 1
        assert "D" in sess.dataplane
        assert b.uid not in sess.dataplane.home_pilots("D")
    finally:
        sess.shutdown()


def test_killed_pilot_kmeans_data_recovers_through_lineage(monkeypatch):
    """Phase 10's case at a small size: simulate pinned to HPC pilot b,
    b killed and recovered, pts re-made on a, analyze gives the cost of a
    direct kmeans_fit on the same points; simulate ran twice."""
    runs = {"simulate": 0}

    def simulate(mesh=None):
        runs["simulate"] += 1
        gen = torch.Generator().manual_seed(11)
        return {"pts": torch.randn(512, 3, generator=gen)}

    def analyze(engine=None, pts=None):
        return {"cost": tkm.kmeans_fit(engine, "pts", 5, iters=2)[1]}

    s = Session(ResourceManager(devices=[CPU] * 3),
                cost_model=tcore.TransferCostModel(dcn_cost_per_byte=1.0))
    try:
        a = s.add_pilot(PilotDescription(n_chips=1, name="a"))
        b = s.add_pilot(PilotDescription(n_chips=1, name="b"))
        s.add_pilot(PilotDescription(n_chips=1, name="ana",
                                     runtime="analytics"))
        s.enable_fault_tolerance(heartbeat_timeout_s=0.2)
        s.run([hpc_stage("simulate", simulate, outputs=("pts",),
                         pilot="b")], timeout=TIMEOUT)
        inj = FailureInjector(list(s.pilots.values()), seed=0)
        kill = inj.kill_pilot(b)
        assert kill is not None and kill.pilot == b.uid
        ev = s.control_plane.recover_pilot(b, reason="test")
        assert ev.lost_datasets == ["pts"] and ev.rematerialized == 1
        assert s.dataplane.home_pilots("pts") == {a.uid}
        assert s.placements["simulate"]["pilot"] == "a"
        assert len(inj.mttr_samples(s.control_plane)) == 1
        out = s.run([analytics_stage("analyze", analyze, inputs=("pts",))],
                    timeout=TIMEOUT)
        assert runs["simulate"] == 2
        eng = AnalyticsEngine(tcore.DeviceGrid([CPU]), tcore.DataPlane())
        eng.put("pts", simulate()["pts"])
        assert out["analyze"]["cost"] == pytest.approx(
            tkm.kmeans_fit(eng, "pts", 5, iters=2)[1], rel=1e-5)
    finally:
        s.shutdown()


def test_device_loss_exhausted_retries_fails_with_diagnostic():
    pm = PilotManager(ResourceManager(devices=[CPU] * 2))
    try:
        pilot = pm.submit(PilotDescription(n_chips=2))
        cu = pilot.submit(ComputeUnitDescription(
            fn=_work, args=(5.0,), n_chips=1, tag="doomed", max_retries=0))
        _until(lambda: cu.assigned_devices, "the CU never bound")
        cu.retries = 1
        pilot.fail_device(cu.assigned_devices[0])
        assert cu.state is CUState.FAILED
        with pytest.raises(RuntimeError, match="exhausted its retry budget"):
            cu.wait(1)
        assert "doomed" in str(cu.error) and pilot.uid in str(cu.error)
    finally:
        pm.shutdown()


def test_device_loss_within_budget_still_requeues():
    pm = PilotManager(ResourceManager(devices=[CPU] * 2))
    try:
        pilot = pm.submit(PilotDescription(n_chips=2))
        cu = pilot.submit(ComputeUnitDescription(
            fn=_work, args=(0.3,), n_chips=1, tag="retry", max_retries=3))
        _until(lambda: cu.assigned_devices, "the CU never bound")
        pilot.fail_device(cu.assigned_devices[0])
        assert cu.follow(timeout=TIMEOUT) == "ok"
        assert len(pilot.devices) == 1
    finally:
        pm.shutdown()


def test_speculation_first_finisher_wins_loser_canceled_uncharged():
    pm = PilotManager(ResourceManager(devices=[CPU] * 2))
    try:
        pilot = pm.submit(PilotDescription(n_chips=2))
        agent = pilot.agent
        gate = {"first": True}

        def racy(mesh=None):
            if gate["first"]:
                gate["first"] = False
                time.sleep(1.5)
                return "loser"
            return "winner"

        cu = pilot.submit(ComputeUnitDescription(
            fn=racy, tag="spec", n_chips=1, tenant="t1", est_runtime_s=0.05))
        assert cu.wait(TIMEOUT) == "winner"
        spec = [c for c in agent._cus.values() if c.speculative_of == cu.uid]
        assert spec and spec[0].state is CUState.DONE
        assert cu.state is CUState.CANCELED and cu.result == "winner"
        time.sleep(1.6)
        assert cu.result == "winner"
        tree = agent.scheduler.queues
        _until(lambda: not any(q.chips_used or q.hbm_used
                               for q in tree.queues.values()),
               "a queue kept a charge")
        assert agent.scheduler.n_free == 2
    finally:
        pm.shutdown()


# --------------------------------------------------- checkpoint / resume
def _stages(runs):
    def make(name, base):
        def fn(mesh=None, **kw):
            runs[name] += 1
            return {name.upper(): np.full((4,), base, np.float32),
                    "n": runs[name]}
        return fn

    return (hpc_stage("a", make("a", 1.0), outputs=("A",)),
            hpc_stage("b", make("b", 2.0), inputs=("A",), outputs=("B",)))


def test_session_checkpoint_resume_skips_completed_stages(tmp_path):
    ck = str(tmp_path / "ckpt")
    runs = {"a": 0, "b": 0}
    stage_a, stage_b = _stages(runs)
    s1 = Session(ResourceManager(devices=[CPU] * 4), checkpoint_dir=ck)
    try:
        s1.add_pilot(PilotDescription(n_chips=4, name="p"))
        s1.run([stage_a], timeout=TIMEOUT)
        s1.checkpoint()
    finally:
        s1.shutdown()
    assert runs == {"a": 1, "b": 0}
    assert not [f for f in os.listdir(ck) if f.endswith(".tmp")]

    s2 = Session.resume(ck, ResourceManager(devices=[CPU] * 4))
    try:
        s2.add_pilot(PilotDescription(n_chips=4, name="p"))
        res = s2.run([stage_a, stage_b], timeout=TIMEOUT)
        assert runs == {"a": 1, "b": 1}
        assert np.allclose(np.asarray(res["a"]["A"]), 1.0)
        assert np.allclose(res["b"]["B"], 2.0)
        assert "A" in s2.dataplane and "B" in s2.dataplane
        assert s2.dataplane.lineage_of("A").stage == "a"
        assert s2.dataplane.home_pilots("A") == {s2.pilots["p"].uid}
        assert s2.dataplane.ledger()["by_reason"]["session-resume"] == 16
    finally:
        s2.shutdown()


def test_resume_requires_a_pilot_before_restoring_data(tmp_path):
    ck = str(tmp_path / "ckpt")
    s1 = Session(ResourceManager(devices=[CPU] * 2), checkpoint_dir=ck)
    try:
        s1.add_pilot(PilotDescription(n_chips=2, name="p"))
        s1.run([hpc_stage("a", lambda mesh=None:
                          {"A": np.ones(2, np.float32)}, outputs=("A",))],
               timeout=TIMEOUT)
        s1.checkpoint()
    finally:
        s1.shutdown()
    s2 = Session.resume(ck, ResourceManager(devices=[CPU] * 2))
    try:
        with pytest.raises(RuntimeError, match="add_pilot"):
            s2.submit_dag([hpc_stage("b", lambda mesh=None: 1)])
    finally:
        s2.shutdown()


def test_resume_refuses_another_journal_version(tmp_path):
    ck = tmp_path / "ckpt"
    ck.mkdir()
    (ck / "manifest.json").write_text(json.dumps({"version": 2}))
    with pytest.raises(ValueError, match="version 2"):
        Session.resume(str(ck), ResourceManager(devices=[CPU]))
    assert Session.CHECKPOINT_VERSION == 1 == jcore.Session.CHECKPOINT_VERSION


def _journal(pkg, ck):
    """Run stage a (and a GFS-archived output) on `pkg`, checkpoint."""
    core = CORE[pkg]
    runs = {"a": 0, "b": 0}
    stage_a, _ = _stages(runs)
    s = core.Session(core.ResourceManager(devices=_devices(pkg, 2)),
                     checkpoint_dir=ck, prefetch=True)
    try:
        s.add_pilot(core.PilotDescription(n_chips=1, name="p"))
        s.add_pilot(core.PilotDescription(n_chips=1, name="q"))
        s.run([stage_a, hpc_stage(
            "c", lambda mesh=None: {"C": np.arange(6, dtype=np.float32)
                                    .reshape(2, 3)},
            outputs=("C",), pilot="q", stage_out=("C",))], timeout=TIMEOUT)
        _until(lambda: s.dataplane.resident_on("C", core.GFS_ARCHIVE),
               "C never reached the archive")
        s.checkpoint()
    finally:
        s.shutdown()
    return runs


def _resume(pkg, ck):
    """Resume `ck` on `pkg`, run a and b; what came back."""
    core = CORE[pkg]
    runs = {"a": 0, "b": 0}
    stage_a, stage_b = _stages(runs)
    s = core.Session.resume(ck, core.ResourceManager(
        devices=_devices(pkg, 2)))
    try:
        s.add_pilot(core.PilotDescription(n_chips=1, name="q"))
        s.add_pilot(core.PilotDescription(n_chips=1, name="p"))
        res = s.run([stage_a, stage_b], timeout=TIMEOUT)
        host = ((lambda x: np.asarray(x)) if pkg == "ref"
                else (lambda x: x.to_numpy()))
        names = {p.uid: n for n, p in s.pilots.items()}
        return {"runs": runs,
                "restored": sorted(s._restored_stages),
                "a": res["a"],
                "arrays": {n: host(s.dataplane.get(n).array)
                           for n in sorted(s.dataplane.names())},
                "homes": {n: sorted(names.get(u, u) for u in
                                    s.dataplane.home_pilots(n))
                          for n in sorted(s.dataplane.names())},
                "lineage": {n: (s.dataplane.lineage_of(n).stage,
                                s.dataplane.lineage_of(n).inputs)
                            for n in sorted(s.dataplane.names())},
                "resume_bytes": s.dataplane.ledger()["by_reason"][
                    "session-resume"]}
    finally:
        s.shutdown()


def _no_tensors(tree):
    if isinstance(tree, dict):
        return all(_no_tensors(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_no_tensors(v) for v in tree)
    return not isinstance(tree, torch.Tensor)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_checkpoint_resumes_across_the_two_packages(tmp_path, writer,
                                                    reader):
    ck = str(tmp_path / writer)
    assert _journal(writer, ck) == {"a": 1, "b": 0}
    with open(os.path.join(ck, "results.pkl"), "rb") as f:
        assert _no_tensors(pickle.load(f))
    got = _resume(reader, ck)
    same = _resume(writer, ck)              # the writer's own resume
    assert got["runs"] == same["runs"] == {"a": 0, "b": 1}
    assert got["restored"] == same["restored"] == ["a", "c"]
    assert got["a"]["n"] == 1
    np.testing.assert_array_equal(got["a"]["A"], np.ones(4, np.float32))
    assert got["homes"] == same["homes"]
    assert got["homes"]["C"] == ["@gfs", "q"] and got["homes"]["A"] == ["p"]
    assert got["lineage"] == same["lineage"] == {
        "A": ("a", ()), "B": ("b", ("A",)), "C": ("c", ())}
    assert got["resume_bytes"] == same["resume_bytes"] == 16 + 24
    assert set(got["arrays"]) == set(same["arrays"]) == {"A", "B", "C"}
    for name, arr in same["arrays"].items():
        assert got["arrays"][name].dtype == arr.dtype
        np.testing.assert_array_equal(got["arrays"][name], arr)


def test_journal_format_matches_the_reference(tmp_path):
    for pkg in CORE:
        _journal(pkg, str(tmp_path / pkg))
    manifests = {}
    for pkg in CORE:
        d = tmp_path / pkg
        assert sorted(os.listdir(d)) == ["data.npz", "manifest.json",
                                         "results.pkl"]
        manifests[pkg] = json.loads((d / "manifest.json").read_text())
        with np.load(d / "data.npz") as data:
            manifests[pkg]["npz"] = {n: (data[n].dtype.str, data[n].shape)
                                     for n in data.files}
    ref, out = manifests["ref"], manifests["port"]
    assert sorted(out) == sorted(ref)
    for key in ("version", "completed", "homes", "lineage", "datasets",
                "virtual_skipped", "npz"):
        assert out[key] == ref[key], key
    assert sorted(out["placements"]) == sorted(ref["placements"])
    for stage, place in out["placements"].items():
        assert place["pilot"] == ref["placements"][stage]["pilot"]


def test_bf16_datasets_survive_a_journal(tmp_path):
    ck = str(tmp_path / "bf16")
    half = np.linspace(-2, 2, 8, dtype=np.float32).astype(ml_dtypes.bfloat16)
    s1 = Session(ResourceManager(devices=[CPU]), checkpoint_dir=ck)
    try:
        s1.add_pilot(PilotDescription(n_chips=1, name="p"))
        s1.run([hpc_stage("h", lambda mesh=None: {"H": half},
                          outputs=("H",))], timeout=TIMEOUT)
        s1.checkpoint()
    finally:
        s1.shutdown()
    s2 = Session.resume(ck, ResourceManager(devices=[CPU]))
    try:
        s2.add_pilot(PilotDescription(n_chips=1, name="p"))
        s2.run([], timeout=TIMEOUT)
        t = s2.dataplane.get("H").array.full()
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(tsession.convert.to_numpy(t), half)
    finally:
        s2.shutdown()


def test_checkpoint_interval_gates_the_journal(tmp_path):
    ck = str(tmp_path / "auto")
    s = Session(ResourceManager(devices=[CPU]), checkpoint_dir=ck,
                checkpoint_interval_s=3600.0)
    try:
        s.add_pilot(PilotDescription(n_chips=1, name="p"))
        s.run([hpc_stage("x", lambda mesh=None: 1)], timeout=TIMEOUT)
        first = json.loads(open(os.path.join(ck, "manifest.json")).read())
        s.run([hpc_stage("y", lambda mesh=None: 2)], timeout=TIMEOUT)
        again = json.loads(open(os.path.join(ck, "manifest.json")).read())
        assert first["completed"] == again["completed"] == ["x"]
        with pytest.raises(ValueError, match="no checkpoint path"):
            Session(ResourceManager(devices=[CPU])).checkpoint()
    finally:
        s.shutdown()
