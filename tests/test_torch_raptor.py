"""Parity of the port's Raptor micro-task overlay with the JAX reference.

The cases of tests/test_raptor.py run on both packages (the reference on
the CPU's JAX devices, the port on ``[torch.device("cpu")] * n``):
results and FIFO/priority execution orders compare equal, and each
case's own assertions hold on the port.  ``Pilot.spawn_raptor`` is the
entry point throughout.
"""
import threading
import time

import jax
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.core import (ComputeUnitDescription, CUState, MicroTask,
                              QueueConfig, RaptorMaster)
from repro_torch.core.compute_unit import ComputeUnit
from repro_torch.core.scheduler import YarnStyleScheduler

CPU = torch.device("cpu")
CORE = {"ref": jcore, "port": tcore}
WAIT = 30.0


class FakeDevice:
    def __init__(self, i):
        self.i = i
        self.type = self.platform = "fake"


def make_sched(n=4, hbm=16, **kw):
    kw.setdefault("locality_delay_rounds", 0)
    return YarnStyleScheduler([FakeDevice(i) for i in range(n)], hbm, **kw)


def cu_of(n_chips=1, **kw):
    return ComputeUnit(ComputeUnitDescription(
        fn=lambda: None, n_chips=n_chips, needs_mesh=False, **kw))


def tenant_queues(core):
    return [core.QueueConfig("default", guaranteed_chips=2),
            core.QueueConfig("tA", guaranteed_chips=2, max_chips=2),
            core.QueueConfig("tB", guaranteed_chips=2)]


def make_pilot(n=8, policy="fifo", queues=False, pkg="port", **kw):
    core = CORE[pkg]
    devices = jax.devices() * n if pkg == "ref" else [CPU] * n
    pm = core.PilotManager(core.ResourceManager(devices=devices))
    pilot = pm.submit(core.PilotDescription(
        n_chips=n, enable_speculation=False, scheduler_policy=policy,
        queues=tenant_queues(core) if queues else None, **kw))
    return pm, pilot


def square(x):
    return x * x


def _until(cond, what, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


# ------------------------------------------------------------------ parity
def _overlay_vs_plain(pkg):
    pm, pilot = make_pilot(4, pkg=pkg)
    try:
        items = list(range(30))
        cus = pilot.agent.submit_many([
            CORE[pkg].ComputeUnitDescription(fn=square, args=(x,), n_chips=1,
                                             needs_mesh=False)
            for x in items])
        via_sched = [cu.wait(WAIT) for cu in cus]
        master = pilot.spawn_raptor(2)
        via_overlay = [t.wait(WAIT) for t in master.map(square, items)]
        stats = master.shutdown()
        return via_sched, via_overlay, stats
    finally:
        pm.shutdown()


def test_overlay_matches_plain_scheduler_and_reference():
    ref, out = _overlay_vs_plain("ref"), _overlay_vs_plain("port")
    assert out[0] == out[1] == ref[0] == ref[1] == [x * x for x in range(30)]
    assert out[2]["submitted"] == out[2]["completed"] == 30
    assert out[2]["failed"] == ref[2]["failed"] == 0


def _fifo_order(pkg):
    pm, pilot = make_pilot(2, pkg=pkg)
    try:
        master = pilot.spawn_raptor(1)
        ran = []
        # unpicklable lambdas run by reference, so the appends land here
        tasks = master.submit_many(
            [(lambda i=i: ran.append(i)) for i in range(50)])
        for t in tasks:
            t.wait(WAIT)
        master.shutdown()
        return ran
    finally:
        pm.shutdown()


def test_submit_many_is_order_stable_under_fifo():
    ref, out = _fifo_order("ref"), _fifo_order("port")
    assert out == ref == list(range(50))


def _priority_order(pkg):
    pm, pilot = make_pilot(2, pkg=pkg)
    try:
        master = pilot.spawn_raptor(1)
        gate = threading.Event()
        ran = []
        master.submit(gate.wait, 5)             # occupy the only worker
        low = master.submit_many([(lambda s=f"low{i}": ran.append(s))
                                  for i in range(3)], priority=0)
        high = master.submit_many([(lambda s=f"high{i}": ran.append(s))
                                   for i in range(3)], priority=5)
        mid = master.submit(lambda: ran.append("mid"), priority=2)
        gate.set()
        for t in low + high + [mid]:
            t.wait(WAIT)
        master.shutdown()
        return ran
    finally:
        pm.shutdown()


def test_priority_beats_arrival_within_the_overlay():
    ref, out = _priority_order("ref"), _priority_order("port")
    assert out == ref == ["high0", "high1", "high2", "mid",
                          "low0", "low1", "low2"]


@pytest.mark.parametrize("sort_keys", [
    [(0, 0), (0, 1), (0, 2)], [(0, 2), (0, 0), (0, 1)],
    [(-5, 3), (0, 1), (-5, 2), (-2, 0)]])
def test_insert_keeps_the_reference_order(sort_keys):
    """RaptorMaster._insert's (-priority, seq) ordering, task for task."""
    from collections import deque
    out = {}
    for pkg, core in CORE.items():
        dq = deque()
        for prio, seq in sort_keys:
            core.RaptorMaster._insert(dq, core.MicroTask(
                seq, square, (seq,), {}, queue="q", tenant=None, tag="t",
                priority=-prio))
        out[pkg] = [t.uid for t in dq]
    assert out["port"] == out["ref"]
    assert out["port"] == [f"mt-{s:08d}" for _, s in sorted(sort_keys)]


def test_errors_propagate_without_killing_the_worker():
    pm, pilot = make_pilot(2)
    try:
        master = pilot.spawn_raptor(1)
        bad = master.submit(lambda: 1 / 0)
        with pytest.raises(RuntimeError) as err:
            bad.wait(WAIT)
        assert isinstance(err.value.__cause__, ZeroDivisionError)
        assert master.submit(square, 7).wait(WAIT) == 49
        stats = master.shutdown()
        assert stats["failed"] == 1 and stats["worker_deaths"] == 0
    finally:
        pm.shutdown()


def test_micro_task_pickles_what_it_can():
    picklable = MicroTask(0, square, (3,), {}, queue="q", tenant=None,
                          tag="t")
    local = MicroTask(1, lambda: 1, (), {}, queue="q", tenant=None, tag="t")
    assert picklable._payload is not None and picklable._raw is None
    assert local._payload is None and local._raw is not None
    fn, args, kwargs = picklable._load()
    assert fn(*args, **kwargs) == 9
    with pytest.raises(TimeoutError):
        picklable.wait(0.01)
    seen = []
    picklable.add_done_callback(seen.append)
    picklable.result = 9
    picklable._finish()
    picklable.add_done_callback(seen.append)    # already done: fires now
    assert seen == [picklable, picklable] and picklable.wait(0) == 9


# -------------------------------------------------------------- accounting
def test_micro_tasks_charge_the_submitting_tenants_queue():
    pm, pilot = make_pilot(8, policy="drf", queues=True)
    try:
        master = pilot.spawn_raptor(2)
        queues = pilot.agent.scheduler.queues.queues
        gate = threading.Event()
        t = master.submit(gate.wait, 5, tenant="tB", queue="tB", hbm_bytes=3)
        _until(lambda: queues["tB"].micro_running == 1,
               "micro-task never charged")
        assert (queues["tB"].chips_used, queues["tB"].hbm_used) == (1, 3)
        assert queues["tA"].chips_used == 0
        gate.set()
        t.wait(WAIT)
        master.shutdown()
        assert (queues["tB"].chips_used, queues["tB"].hbm_used) == (0, 0)
        assert queues["tB"].micro_running == 0
        assert queues["tB"].micro_done == 1
    finally:
        pm.shutdown()


@BOTH
def test_drf_caps_hold_over_micro_tasks(pkg):
    pm, pilot = make_pilot(8, policy="drf", queues=True, pkg=pkg)
    try:
        master = pilot.spawn_raptor(4)
        lock = threading.Lock()
        running, peak = [], [0]

        def tracked(x):
            with lock:
                running.append(x)
                peak[0] = max(peak[0], len(running))
            time.sleep(0.03)
            with lock:
                running.remove(x)
            return x

        tasks = master.map(tracked, list(range(20)), tenant="tA", queue="tA")
        assert [t.wait(60) for t in tasks] == list(range(20))
        master.shutdown()
        assert peak[0] == 2, f"tA ran {peak[0]} concurrent micro-tasks"
    finally:
        pm.shutdown()


@BOTH
def test_unknown_queue_rejected_at_submit(pkg):
    pm, pilot = make_pilot(4, policy="drf", queues=True, pkg=pkg)
    try:
        master = pilot.spawn_raptor(1)
        with pytest.raises(ValueError, match="nope"):
            master.submit(square, 1, queue="nope")
        master.shutdown()
    finally:
        pm.shutdown()


# ------------------------------------------------------------ worker death
def test_worker_death_requeues_inflight_micro_task():
    pm, pilot = make_pilot(4)
    try:
        master = pilot.spawn_raptor(2)
        gate = threading.Event()
        master.fail_worker(master.worker_ids()[0])
        tasks = master.map(lambda x: gate.wait(5) and x, [1, 2, 3, 4])
        time.sleep(0.2)          # let the doomed worker acquire and die
        gate.set()
        assert [t.wait(WAIT) for t in tasks] == [1, 2, 3, 4]
        _until(lambda: master.stats["worker_deaths"] >= 1,
               "death never reaped")
        assert master.stats["requeued"] >= 1
        _until(lambda: len(master.worker_ids()) == 2, "no replacement")
        stats = master.shutdown()
        assert stats["completed"] == 4
        assert pilot.agent.scheduler.queues.queues["default"] \
            .micro_running == 0
    finally:
        pm.shutdown()


# ---------------------------------------------------------------- shutdown
def test_shutdown_drains_pending_tasks():
    pm, pilot = make_pilot(4)
    try:
        master = pilot.spawn_raptor(2)
        tasks = master.map(square, list(range(200)))
        stats = master.shutdown(drain=True)
        assert [t.wait(1) for t in tasks] == [x * x for x in range(200)]
        assert stats["completed"] == 200
        assert master._cu.done and not master.alive
        with pytest.raises(RuntimeError, match="shut down"):
            master.submit(square, 1)
    finally:
        pm.shutdown()


def test_shutdown_without_drain_cancels_pending():
    pm, pilot = make_pilot(2)
    try:
        master = pilot.spawn_raptor(1)
        gate = threading.Event()
        first = master.submit(gate.wait, 5)
        pending = master.map(square, list(range(5)))
        time.sleep(0.1)                         # first task is in flight
        done = threading.Thread(target=master.shutdown,
                                kwargs={"drain": False})
        done.start()
        gate.set()
        done.join(timeout=WAIT)
        assert not done.is_alive()
        assert first.wait(5) is True
        for t in pending:
            with pytest.raises(RuntimeError, match="shut down"):
                t.wait(1)
    finally:
        pm.shutdown()


def test_spawn_raptor_fails_fast_when_the_gang_cannot_fit():
    pm, pilot = make_pilot(2)
    try:
        with pytest.raises(RuntimeError, match="failed to start"):
            pilot.spawn_raptor(3)
        with pytest.raises(ValueError, match=">= 1"):
            RaptorMaster(pilot, 0)
        master = pilot.spawn_raptor(2, name="named")
        assert master.uid == "named" and master.alive
        master.shutdown()
    finally:
        pm.shutdown()


# -------------------------------------------------------------- elasticity
def test_grow_and_shrink_extension_workers():
    pm, pilot = make_pilot(6)
    try:
        master = pilot.spawn_raptor(2)
        master.grow(2)
        _until(lambda: len(master.worker_ids()) == 4,
               "extensions never started", 10)
        assert master.shrink(1) == 1
        _until(lambda: len(master.worker_ids()) == 3,
               "shrink never applied", 10)
        assert master.shrink(5) == 1            # only 1 extension left
        tasks = master.map(square, list(range(20)))
        assert [t.wait(WAIT) for t in tasks] == [x * x for x in range(20)]
        master.shutdown()
    finally:
        pm.shutdown()


def test_heartbeat_exports_overlay_backlog():
    pm, pilot = make_pilot(4)
    try:
        master = pilot.spawn_raptor(1)
        gate = threading.Event()
        master.submit(gate.wait, 5)
        master.map(square, list(range(9)))
        ov = pilot.agent.heartbeat()["overlays"][master.uid]
        assert ov["workers"] == 1
        assert ov["pending"] >= 8 and ov["backlog_per_worker"] >= 8
        gate.set()
        master.shutdown()
        assert pilot.agent.heartbeat()["overlays"] == {}
    finally:
        pm.shutdown()


def test_control_plane_grows_hot_overlay():
    pm, pilot = make_pilot(6)
    try:
        master = pilot.spawn_raptor(1)
        gate = threading.Event()
        master.submit(gate.wait, 10)
        tasks = master.map(lambda x: gate.wait(10) and x, list(range(30)))
        assert pm.control_plane.scale_overlays().get(master.uid, 0) == 1
        gate.set()
        for t in tasks:
            t.wait(WAIT)
        master.shutdown()
    finally:
        pm.shutdown()


# ------------------------------------------------------------- session.map
def _session_map(pkg):
    core = CORE[pkg]
    devices = jax.devices() * 6 if pkg == "ref" else [CPU] * 6
    s = core.Session(core.ResourceManager(devices=devices))
    try:
        s.add_pilot(core.PilotDescription(
            n_chips=6, name="hpc0", scheduler_policy="drf",
            queues=tenant_queues(core)))
        out = [s.map(square, list(range(40)), tenant="tB", queue="tB")]
        first = next(iter(s._overlays.values()))
        out.append(s.map(square, [1, 2], tenant="tB", queue="tB"))
        reused = next(iter(s._overlays.values())) is first
        out.append(s.tenant("tB2", queue="tB").map(square, [3]))
        q = s.pilots["hpc0"].agent.scheduler.queues.queues["tB"]
        return out, len(s._overlays), reused, q.micro_done, first.n_workers
    finally:
        s.shutdown()


def test_session_map_routes_through_an_overlay():
    ref, out = _session_map("ref"), _session_map("port")
    assert out == ref
    assert out[0] == [[x * x for x in range(40)], [1, 4], [9]]
    assert out[1] == 1 and out[2] and out[3] == 43 and out[4] == 3


# ------------------------------------------------- scheduler fast path
def test_scheduler_submit_many_is_all_or_nothing():
    sched = make_sched(4, queues=[QueueConfig("only"),
                                  QueueConfig("default")])
    good = [cu_of(queue="only") for _ in range(3)]
    with pytest.raises(ValueError):
        sched.submit_many(good + [cu_of(queue="nope")])
    assert sched.backlog()["queue_len"] == 0
    sched.submit_many(good)
    assert sched.backlog()["queue_len"] == 3
    assert sched.stats["batch_submits"] == 1


def test_backlog_snapshot_cached_until_version_changes():
    sched = make_sched(2)
    b1 = sched.backlog()
    assert sched.backlog() is b1
    v = sched.version()
    sched.submit(cu_of())
    assert sched.version() != v
    b2 = sched.backlog()
    assert b2 is not b1 and b2["queue_len"] == 1
    assert sched.backlog() is b2


def test_carve_out_wakes_on_release_not_poll():
    sched = make_sched(2)
    cu = cu_of(2)
    sched.submit(cu)
    assert sched.try_schedule()
    got = {}

    def carve():
        t0 = time.monotonic()
        got["idxs"] = sched.carve_out(2, timeout=10.0)
        got["dt"] = time.monotonic() - t0

    th = threading.Thread(target=carve)
    th.start()
    time.sleep(0.15)
    assert "idxs" not in got
    cu._set_state(CUState.DONE)
    sched.release(cu)
    th.join(timeout=5)
    assert not th.is_alive()
    assert len(got["idxs"]) == 2 and got["dt"] < 5.0
    sched.restore(got["idxs"])


def test_carve_out_times_out_when_chips_stay_busy():
    sched = make_sched(2)
    sched.submit(cu_of(2))
    assert sched.try_schedule()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="busy"):
        sched.carve_out(1, timeout=0.2)
    assert time.monotonic() - t0 < 2.0


def test_agent_wake_is_event_driven():
    pm, pilot = make_pilot(2)
    try:
        assert pilot.agent.scheduler.notify == pilot.agent._wake.set
        pilot.agent._wake.clear()
        pilot.agent.scheduler.submit(cu_of())
        assert pilot.agent._wake.is_set()
    finally:
        pm.shutdown()
