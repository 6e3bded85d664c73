"""Parity of the port's Pilot-Abstraction core with the JAX reference:
the 13 cases of tests/test_pilot_core.py (lifecycle, bin packing, gang
atomicity, retry, priority, app-master reuse, Mode I/II, speculation,
device-failure requeue, elastic resize, locality).

Each case runs one scenario through both packages -- the reference on
``jax.devices() * n``, the port on ``[torch.device("cpu")] * n`` -- and
compares what came out (results, CU states, orders, scheduler stats,
free-slot counts) by equality; the reference's own properties are then
asserted on that common outcome.  Timing-dependent cases keep the
reference's sleeps and bounds."""
import contextlib
import time

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as jcore
import repro.core.modes as jmodes
import repro_torch.core as tcore
import repro_torch.core.modes as tmodes

CPU = torch.device("cpu")
CORE = {"ref": jcore, "port": tcore}


def _devices(pkg, n):
    return jax.devices() * n if pkg == "ref" else [CPU] * n


@contextlib.contextmanager
def _pm(pkg, n=1):
    core = CORE[pkg]
    pm = core.PilotManager(core.ResourceManager(devices=_devices(pkg, n)))
    try:
        yield core, pm
    finally:
        pm.shutdown()


def both(run):
    """One scenario on both packages; the outcomes must be equal."""
    ref, port = run("ref"), run("port")
    assert port == ref
    return ref


def test_pilot_lifecycle():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1, name="t"))
            out = [pilot.state.value, len(pilot.devices),
                   pilot.startup_s() >= 0]
            pilot.shutdown()
            return out + [pilot.state.value]
    assert both(run) == ["active", 1, True, "done"]


def test_cu_executes_and_reports_timings():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1))
            cu = pilot.submit(core.ComputeUnitDescription(
                fn=lambda x, mesh=None: x * 2, args=(21,), tag="t"))
            return (cu.wait(30), cu.state.value,
                    cu.overhead_s() is not None and cu.overhead_s() >= 0,
                    cu.runtime_s() is not None)
    assert both(run) == (42, "done", True, True)


def test_many_cus_bin_packed():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1))
            cus = [pilot.submit(core.ComputeUnitDescription(
                fn=lambda i=i, mesh=None: i * i, n_chips=1, tag="map"))
                for i in range(20)]
            return ([cu.wait(60) for cu in cus],
                    [cu.state.value for cu in cus])
    results, states = both(run)
    assert sorted(results) == sorted(i * i for i in range(20))
    assert set(states) == {"done"}


def test_gang_scheduling_atomicity():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1))
            ok = pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: len(mesh.devices.flat), n_chips=1,
                gang=True))
            got = ok.wait(30)
            too_big = pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: None, n_chips=99, gang=True))
            with pytest.raises(RuntimeError) as err:
                too_big.wait(30)
            reason = str(too_big.error).replace(too_big.uid, "<uid>")
            return (got, too_big.state.value, type(too_big.error).__name__,
                    reason.replace(pilot.uid, "<pilot>"),
                    type(err.value).__name__)
    got, state, *_ = both(run)
    assert (got, state) == (1, "failed")


def test_cu_failure_and_retry():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1))
            attempts = []

            def flaky(mesh=None):
                attempts.append(1)
                if len(attempts) < 3:
                    raise ValueError("boom")
                return "recovered"

            cu = pilot.submit(core.ComputeUnitDescription(
                fn=flaky, max_retries=3, tag="f"))
            first = (cu.wait(30), len(attempts), cu.retries)
            cu2 = pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: 1 / 0, max_retries=1, tag="f2"))
            with pytest.raises(RuntimeError):
                cu2.wait(30)
            return first + (cu2.state.value, type(cu2.error).__name__,
                            cu2.retries)
    assert both(run) == ("recovered", 3, 2, "failed", "ZeroDivisionError", 1)


def test_priority_ordering():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1))
            order = []

            def task(name, mesh=None):
                order.append(name)
                time.sleep(0.05)
                return name

            blocker = pilot.submit(core.ComputeUnitDescription(
                fn=task, args=("blocker",), n_chips=1))
            time.sleep(0.02)  # let it start
            low = pilot.submit(core.ComputeUnitDescription(
                fn=task, args=("low",), n_chips=1, priority=0))
            high = pilot.submit(core.ComputeUnitDescription(
                fn=task, args=("high",), n_chips=1, priority=10))
            # `high` preempts the blocker when it arrives in time, and
            # wait() then hands back the clone: follow() chases it.  How
            # often the blocker ran depends on that timing, so the order
            # compared is that of the two queued CUs
            results = [c.follow(30) for c in (blocker, low, high)]
            return results, [n for n in order if n != "blocker"]
    results, order = both(run)
    assert results == ["blocker", "low", "high"]
    assert order == ["high", "low"]


def test_app_master_reuse_stats():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1,
                                                    reuse_app_master=True))
            got = [pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: 1, app_id="app1")).wait(30)
                for _ in range(5)]
            stats = pilot.agent.scheduler.stats
            return got, stats["app_masters_started"], \
                stats["app_masters_reused"]
    _, started, reused = both(run)
    assert started == 1 and reused >= 4


def test_mode1_spawn_and_return_chips():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1))
            free = [pilot.agent.scheduler.n_free]
            cluster = pilot.spawn_analytics_cluster(1)
            free.append(pilot.agent.scheduler.n_free)
            size = cluster.mesh.size
            cluster.shutdown()
            return free + [pilot.agent.scheduler.n_free], size
    assert both(run) == ([1, 0, 1], 1)


def test_mode2_hpc_in_analytics_cluster():
    def ref_stage(mesh=None):
        with mesh:
            return float(jnp.sum(jnp.ones((4, 4))))

    def port_stage(mesh=None):
        return float(torch.ones((4, 4), device=mesh.devices.flat[0]).sum())

    ref = jmodes.AnalyticsCluster(jax.devices()[:1]).run_hpc(ref_stage)
    port = tmodes.AnalyticsCluster([CPU]).run_hpc(port_stage)
    assert port == ref == 16.0


def test_straggler_speculation():
    """A CU overrunning its tag's EMA gets a speculative duplicate
    (two logical slots on the one real device), which finishes first."""
    def run(pkg):
        with _pm(pkg, 2) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=2))
            agent = pilot.agent

            def fast(mesh=None):
                time.sleep(0.01)
                return "ok"

            for _ in range(3):  # build the EMA
                pilot.submit(core.ComputeUnitDescription(
                    fn=fast, tag="work", needs_mesh=False)).wait(30)
            slow_gate = {"sleep": 2.5}

            def maybe_slow(mesh=None):
                s = slow_gate["sleep"]
                slow_gate["sleep"] = 0.0  # the speculative copy is fast
                time.sleep(s)
                return "done"

            cu = pilot.submit(core.ComputeUnitDescription(
                fn=maybe_slow, tag="work", needs_mesh=False))
            result = cu.wait(30)
            spec = [c for c in agent._cus.values()
                    if c.speculative_of == cu.uid]
            return (result, len(spec), cu.state.value,
                    cu.runtime_s() < 2.4)
    result, n_spec, _, fast_enough = both(run)
    assert result == "done" and n_spec >= 1 and fast_enough


def test_device_failure_requeues_cu():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1))
            impacted = pilot.fail_device(pilot.devices[0])
            return (type(impacted).__name__, impacted, len(pilot.devices),
                    pilot.agent.scheduler.n_slots,
                    [{k: v for k, v in e.items() if k not in ("t", "pilot")}
                     for e in pm.rm.lease_events])
    kind, _, n_devices, *_ = both(run)
    assert kind == "list" and n_devices == 0


def test_elastic_resize():
    def run(pkg):
        with _pm(pkg) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=1))
            pilot.resize(1)
            return len(pilot.devices), pilot.agent.scheduler.n_free
    n_devices, n_free = both(run)
    assert n_devices == 1 and n_free >= 1


def test_locality_preference():
    """CUs with data deps prefer the pilot holding the data."""
    def run(pkg):
        with _pm(pkg) as (core, pm):
            p1 = pm.submit(core.PilotDescription(n_chips=1))
            if pkg == "ref":
                arr = jax.device_put(jnp.ones((128,)), p1.devices[0])
            else:
                arr = core.place(torch.ones(128), core.replicated_sharding(
                    p1.devices[:1]))
            p1.data.put("ds", arr)
            um = core.UnitManager([p1])
            cu = um.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: "ran", data=("ds",), tag="loc"))
            return cu.wait(30), p1.agent.scheduler.stats["locality_hits"]
    ran, hits = both(run)
    assert ran == "ran" and hits >= 1
