"""Parity of the port's core (queues, scheduler, resource manager, pilots,
Mode I) with the JAX reference.  Scheduler cases come from
tests/test_fairshare.py and tests/test_elastic.py and run on both
packages with identical submissions; orders and events compare equal."""
import time

import jax
import numpy as np
import pytest
import torch

import repro.core.compute_unit as jcu
import repro.core.queues as jq
import repro.core.resource_manager as jrm
import repro.core.scheduler as jsched

import repro_torch.core.compute_unit as tcu
import repro_torch.core.queues as tq
import repro_torch.core.resource_manager as trm
import repro_torch.core.scheduler as tsched
from repro_torch.analytics import kmeans as tkm
from repro_torch.core import (ComputeUnitDescription, DataPlane, DeviceGrid,
                              PilotDescription, PilotManager, ResourceManager,
                              place)
from repro_torch.core.agent import platform_of

CPU = torch.device("cpu")
PACKAGES = {"ref": (jcu, jq, jsched), "port": (tcu, tq, tsched)}


class FakeDevice:
    def __init__(self, i):
        self.i = i
        self.type = self.platform = "fake"


def _sched(pkg, n=4, hbm=16, **kw):
    _, _, sched = PACKAGES[pkg]
    kw.setdefault("locality_delay_rounds", 0)
    return sched.YarnStyleScheduler([FakeDevice(i) for i in range(n)], hbm,
                                    **kw)


def _cu(pkg, n_chips=1, **kw):
    cu_mod = PACKAGES[pkg][0]
    return cu_mod.ComputeUnit(cu_mod.ComputeUnitDescription(
        fn=lambda: None, n_chips=n_chips, **kw))


def _queues(pkg, *specs):
    return [PACKAGES[pkg][1].QueueConfig(name, **kw) for name, kw in specs]


def _drain_order(pkg, sched, cus, rounds=200):
    """Bind rounds to completion: [(submission index, device idxs)]."""
    done = PACKAGES[pkg][0].CUState.DONE
    order = []
    for _ in range(rounds):
        for cu, idxs in sched.try_schedule():
            order.append((cus.index(cu), idxs))
            cu._set_state(done)
            sched.release(cu)
        if len(order) >= len(cus):
            break
    return order


# ------------------------------------------------- queue pick orders
def _fifo_priority(pkg):
    sched = _sched(pkg, 1)
    cus = [_cu(pkg, priority=p) for p in (0, 5, 2, 5, 2, 0)]
    for c in cus:
        sched.submit(c)
    return _drain_order(pkg, sched, cus)


def _fifo_queues(pkg):
    sched = _sched(pkg, 1, queues=_queues(pkg, ("a", {}), ("b", {})))
    cus = [_cu(pkg, queue=q) for q in "aba"]
    for c in cus:
        sched.submit(c)
    return _drain_order(pkg, sched, cus)


def _drf_three_tenants(pkg):
    sched = _sched(pkg, 12, policy="drf",
                   queues=_queues(pkg, ("a", {}), ("b", {}), ("c", {})))
    cus = [_cu(pkg, queue=q) for q, n in (("a", 24), ("b", 4), ("c", 4))
           for _ in range(n)]
    for c in cus:
        sched.submit(c)
    bound = [(cus.index(cu), idxs) for cu, idxs in sched.try_schedule()]
    return bound, {q: sched.queues.get(q).chips_used for q in "abc"}


def _drf_weights(pkg):
    sched = _sched(pkg, 8, policy="drf",
                   queues=_queues(pkg, ("a", {"weight": 2.0}), ("b", {}),
                                  ("c", {})))
    cus = [_cu(pkg, queue=q) for q in "abc" for _ in range(8)]
    for c in cus:
        sched.submit(c)
    bound = [(cus.index(cu), idxs) for cu, idxs in sched.try_schedule()]
    return bound, {q: sched.queues.get(q).chips_used for q in "abc"}


def _capacity_starved_first(pkg):
    sched = _sched(pkg, 2, policy="capacity",
                   queues=_queues(pkg, ("prod", {"guaranteed_chips": 1}),
                                  ("batch", {})))
    cus = [_cu(pkg, queue="batch") for _ in range(3)] + [_cu(pkg,
                                                             queue="prod")]
    for c in cus:
        sched.submit(c)
    return [(cus.index(cu), idxs) for cu, idxs in sched.try_schedule()]


def _capacity_borrowing(pkg):
    sched = _sched(pkg, 4, policy="capacity",
                   queues=_queues(pkg, ("prod", {"guaranteed_chips": 2}),
                                  ("batch", {"max_chips": 3})))
    cus = [_cu(pkg, queue="batch") for _ in range(6)]
    for c in cus:
        sched.submit(c)
    bound = [(cus.index(cu), idxs) for cu, idxs in sched.try_schedule()]
    return bound, sched.n_free


def _capacity_reclaim(pkg):
    sched = _sched(pkg, 4, policy="capacity",
                   queues=_queues(pkg, ("prod", {"guaranteed_chips": 2}),
                                  ("batch", {"guaranteed_chips": 1})))
    batch = [_cu(pkg, queue="batch", priority=p) for p in (3, 0, 1, 2)]
    for c in batch:
        sched.submit(c)
    for cu, _ in sched.try_schedule():
        cu._set_state(PACKAGES[pkg][0].CUState.RUNNING)
    for _ in range(2):
        sched.submit(_cu(pkg, queue="prod"))
    victims = sched.reclaim_victims({c.uid: c for c in batch})
    return [batch.index(next(c for c in batch if c.uid == v))
            for v in victims]


@pytest.mark.parametrize("case", [_fifo_priority, _fifo_queues,
                                  _drf_three_tenants, _drf_weights,
                                  _capacity_starved_first,
                                  _capacity_borrowing, _capacity_reclaim],
                         ids=lambda f: f.__name__.strip("_"))
def test_queue_policies_pick_as_reference(case):
    assert case("port") == case("ref")


# ---------------------------------------- carve-out, restore, gang binding
def test_carve_out_and_restore_match_reference():
    def run(pkg):
        sched = _sched(pkg, 4, hbm=16)
        take = sched.carve_out(2)
        state = (take, sched.n_free, sorted(sched._carved),
                 dict(sched._mem_free))
        sched.restore(take)
        sched.restore(take)                     # idempotent
        return state, sched.n_free, dict(sched._mem_free)
    assert run("port") == run("ref")


def test_gang_reservation_binds_as_reference():
    """A stream of small CUs must not starve a queued gang (the case of
    tests/test_elastic.py): both packages bind it in the same round, on
    the same chips."""
    def run(pkg):
        done = PACKAGES[pkg][0].CUState.DONE
        sched = _sched(pkg, 2, gang_reservation_rounds=3)
        running = []
        sched.submit(_cu(pkg))
        running += [c for c, _ in sched.try_schedule()]
        gang = _cu(pkg, 2, gang=True)
        sched.submit(gang)
        for rnd in range(30):
            sched.submit(_cu(pkg))
            for c, idxs in sched.try_schedule():
                if c is gang:
                    return rnd, idxs, sched.stats["gang_reservations"]
                running.append(c)
            old = running.pop(0)
            old._set_state(done)
            sched.release(old)
        return None
    out = run("port")
    assert out is not None and out[2] >= 1
    assert out == run("ref")


def test_oversized_gang_fails_fast_as_reference():
    def run(pkg):
        sched = _sched(pkg, 4)
        sched.begin_drain([2, 3])
        cu = _cu(pkg, 4, gang=True)
        sched.submit(cu)
        sched.try_schedule()
        devs = sched.finish_drain([2, 3])
        return cu.state.value, str(cu.error), [d.i for d in devs]
    assert run("port") == run("ref")


# ---------------------------------------------------- resource manager
def _lease_events(rm_mod, pool):
    rm = rm_mod.ResourceManager(devices=pool)
    a = rm.grant(2, "p0")
    rm.grant(1, "p1")
    rm.reclaim("p0", a[:1])
    with pytest.raises(ValueError, match="holds no lease"):
        rm.reclaim("nobody", a[1:])
    rm.mark_failed(pool[-1])
    rm.grant(1, "p2")
    rm.release("p1")
    rm.release_devices(a[1:])
    return ([{k: v for k, v in e.items() if k != "t"}
             for e in rm.lease_events], rm.stats, rm.free_indices())


@pytest.mark.parametrize("pool", ["aliased", "distinct"])
def test_lease_events_match_reference(pool):
    if pool == "aliased":
        ref_pool, port_pool = jax.devices() * 4, [CPU] * 4
    else:
        ref_pool = [FakeDevice(i) for i in range(4)]
        port_pool = [FakeDevice(i) for i in range(4)]
    assert _lease_events(trm, port_pool) == _lease_events(jrm, ref_pool)


def test_resource_manager_raises_without_cuda_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        ResourceManager()
    with pytest.raises(RuntimeError, match="devices="):
        PilotManager()
    rm = ResourceManager(devices=[CPU] * 2)     # the CPU only when asked
    assert rm.hbm_per_chip == trm.HBM_BYTES_PER_CHIP == 80 * 1024**3


def test_platform_words_and_h100_defaults():
    assert platform_of(torch.device("cuda", 0)) == "gpu"
    assert platform_of(CPU) == "cpu"
    desc = PilotDescription(n_chips=1)
    assert (desc.peak_flops_per_chip, desc.hbm_bw_per_chip) == (989e12,
                                                                3.35e12)


# ------------------------------------------------------------------ Mode I
@pytest.fixture
def pm():
    m = PilotManager(ResourceManager(devices=[CPU] * 2))
    yield m
    m.shutdown()


def test_chips_return_to_parent_free_set(pm):
    pilot = pm.submit(PilotDescription(n_chips=2, name="m1"))
    free_before = set(pilot.agent.scheduler._free)
    assert pilot.agent.scheduler.n_free == 2
    cluster = pilot.spawn_analytics_cluster(2)
    assert pilot.agent.scheduler.n_free == 0
    assert all(d is CPU for d in cluster.mesh.devices.flat)   # pool objects
    cluster.shutdown()
    assert pilot.agent.scheduler.n_free == 2
    assert set(pilot.agent.scheduler._free) == free_before


def test_shutdown_is_idempotent(pm):
    pilot = pm.submit(PilotDescription(n_chips=2, name="m1i"))
    cluster = pilot.spawn_analytics_cluster(1)
    cluster.shutdown()
    n_after_first = pilot.agent.scheduler.n_free
    cluster.shutdown()
    cluster.shutdown()
    assert pilot.agent.scheduler.n_free == n_after_first == 2


def test_cluster_usable_then_chips_still_accounted(pm):
    pilot = pm.submit(PilotDescription(n_chips=2, name="m1u"))
    assert pilot.agent.lrm.info()["platform"] == "cpu"
    cluster = pilot.spawn_analytics_cluster(1)
    cluster.engine.put("pts", tkm.make_dataset(64, 3, n_clusters=4, seed=0,
                                               device=CPU))
    centroids, cost = tkm.kmeans_fit(cluster.engine, "pts", 4, iters=2,
                                     use_kernel=True)
    assert np.isfinite(cost) and centroids.shape == (4, 3)
    cluster.shutdown()
    cu = pilot.submit(ComputeUnitDescription(
        fn=lambda mesh=None: (len(mesh.devices.flat), type(mesh)),
        n_chips=2, gang=True))
    assert cu.wait(60) == (2, DeviceGrid)


def test_rebalance_moves_chips_and_evicts_data():
    """The drain -> evict -> reclaim -> grant -> absorb pipeline of
    tests/test_elastic.py on the port: the cold pilot's dataset survives
    on its shrunken slice, its bytes itemized on the ledger."""
    rm = ResourceManager(devices=[CPU] * 4)
    shared = DataPlane()
    pm = PilotManager(rm, hysteresis=0.25, drain_preempt_after_s=0.1)
    try:
        hot = pm.submit(PilotDescription(n_chips=2, name="hot",
                                         enable_speculation=False),
                        data_registry=shared)
        cold = pm.submit(PilotDescription(n_chips=2, name="cold",
                                          enable_speculation=False),
                         data_registry=shared)
        shared.put("cold-ds", place(np.ones((64, 8), np.float32),
                                    DeviceGrid(cold.devices[:1])
                                    .block_placement()), pilot=cold.uid)
        cus = [hot.submit(ComputeUnitDescription(
            fn=lambda mesh=None: time.sleep(0.05) or 1,
            n_chips=1, tag="load", needs_mesh=False)) for _ in range(12)]
        ev = pm.control_plane.rebalance()
        assert ev is not None and ev.src == cold.uid and ev.dst == hot.uid
        assert len(hot.devices) == 2 + ev.n_chips
        assert len(rm.holdings(hot.uid)) == len(hot.devices)
        assert shared.ledger()["by_reason"].get("drain-evict", 0) > 0
        assert ev.evicted_bytes > 0
        np.testing.assert_array_equal(shared.get("cold-ds").array.to_numpy(),
                                      np.ones((64, 8), np.float32))
        assert sum(cu.follow(30.0) for cu in cus) == 12
        kinds = [e["event"] for e in rm.lease_events]
        assert "reclaim" in kinds and kinds.count("grant") >= 3
    finally:
        pm.shutdown()
