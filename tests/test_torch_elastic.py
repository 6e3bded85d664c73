"""Parity of the port's elastic resource management with the JAX
reference: the 16 cases of tests/test_elastic.py that had no mirror
(the rebalance, the Session grow and the lineage-after-drain cases are
in test_torch_core.py and test_torch_session.py).

Scheduler-level cases build the same ``FakeDevice`` pool for
``repro.core.scheduler.YarnStyleScheduler`` and
``repro_torch.core.scheduler.YarnStyleScheduler``; pilot-level cases run
the reference on ``jax.devices() * n`` and the port on
``[torch.device("cpu")] * n``.  Each compares bind orders, device
indices, free/slot counts, lease events (pilot uids mapped to names,
without ``t``) and error messages by equality.  Timing-dependent cases
keep the reference's sleeps, timeouts and bounds."""
import contextlib
import time

import jax
import pytest
import torch

import repro.core as jcore
import repro.core.compute_unit as jcu
import repro.core.scheduler as jsched
import repro_torch.core as tcore
import repro_torch.core.compute_unit as tcu
import repro_torch.core.scheduler as tsched

CPU = torch.device("cpu")
CORE = {"ref": jcore, "port": tcore}
PACKAGES = {"ref": (jcu, jsched), "port": (tcu, tsched)}


class FakeDevice:
    def __init__(self, i):
        self.i = i
        self.type = self.platform = "fake"


def make_sched(pkg, n=4, hbm=16, **kw):
    kw.setdefault("locality_delay_rounds", 0)
    return PACKAGES[pkg][1].YarnStyleScheduler(
        [FakeDevice(i) for i in range(n)], hbm, **kw)


def cu_of(pkg, n_chips=1, *, gang=False, memory_bytes=0, priority=0):
    cu_mod = PACKAGES[pkg][0]
    return cu_mod.ComputeUnit(cu_mod.ComputeUnitDescription(
        fn=lambda: None, n_chips=n_chips, gang=gang,
        memory_bytes=memory_bytes, priority=priority))


def state(pkg, name):
    return getattr(PACKAGES[pkg][0].CUState, name)


@contextlib.contextmanager
def _pm(pkg, n, **kw):
    core = CORE[pkg]
    devices = jax.devices() * n if pkg == "ref" else [CPU] * n
    pm = core.PilotManager(core.ResourceManager(devices=devices), **kw)
    try:
        yield core, pm
    finally:
        pm.shutdown()


def lease_events(pm):
    """The RM's lease log without ``t``, pilot uids mapped to names."""
    names = {p.uid: p.desc.name or f"#{i}" for i, p in enumerate(pm.pilots)}
    return [{**{k: v for k, v in e.items() if k != "t"},
             "pilot": names.get(e["pilot"], e["pilot"])}
            for e in pm.rm.lease_events]


def both(run):
    """One scenario on both packages; the outcomes must be equal."""
    ref, port = run("ref"), run("port")
    assert port == ref
    return ref


# ----------------------------------------------------------- carve-out API
def test_carve_out_and_restore_with_hbm_accounting():
    def run(pkg):
        sched = make_sched(pkg, 4, hbm=16)
        take = sched.carve_out(2)
        out = [take, sched.n_free, sorted(sched._carved),
               [sched._mem_free[i] for i in take]]
        sched.restore(take)
        out += [sched.n_free, sorted(sched._carved), dict(sched._mem_free)]
        sched.restore(take)                          # idempotent
        return out + [sched.n_free]
    take, n_free, carved, mem, n_free2, carved2, mem2, n_free3 = both(run)
    assert len(take) == 2 and n_free == 2 and carved == sorted(take)
    assert mem == [0, 0]                  # the chip's HBM went with it
    assert n_free2 == 4 and not carved2 and all(m == 16 for m in mem2.values())
    assert n_free3 == 4


def test_carve_out_times_out_when_busy():
    def run(pkg):
        sched = make_sched(pkg, 1)
        sched.submit(cu_of(pkg, 1))
        bound = [idxs for _, idxs in sched.try_schedule()]
        with pytest.raises(RuntimeError, match="carve out") as err:
            sched.carve_out(1, timeout=0.05)
        return bound, str(err.value)
    bound, _ = both(run)
    assert bound == [[0]]


def test_agent_reserve_chips_goes_through_carve_out():
    def run(pkg):
        with _pm(pkg, 2) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=2, name="carve"))
            sched = pilot.agent.scheduler
            idxs = pilot.agent.reserve_chips(1)
            out = [idxs, set(idxs) <= sched._carved, sched.n_free]
            pilot.agent.return_chips(idxs)
            return out + [sched.n_free, sorted(sched._carved),
                          lease_events(pm)]
    _, carved, n_free, n_free2, carved2, _ = both(run)
    assert carved and n_free == 1 and n_free2 == 2 and not carved2


# -------------------------------------------------------- HBM ceil division
@pytest.mark.parametrize("total,n", [(16, 3), (16, 1), (0, 4), (None, 4),
                                     (11, 2), (10, 2)])
def test_mem_per_chip_is_ceil(total, n):
    got = tsched.mem_per_chip(total, n)
    assert got == jsched.mem_per_chip(total, n)
    assert got == (-(-(total or 0) // n))


def test_hbm_remainder_not_dropped_on_admission():
    def run(pkg):
        sched = make_sched(pkg, 2, hbm=5)
        cu = cu_of(pkg, 2, memory_bytes=11)
        sched.submit(cu)
        refused = sched.try_schedule()
        ok = cu_of(pkg, 2, memory_bytes=10)
        sched.submit(ok)
        bound = [(c is ok, idxs) for c, idxs in sched.try_schedule()]
        ok._set_state(state(pkg, "DONE"))
        sched.release(ok)
        return refused, bound, dict(sched._mem_free)
    refused, bound, mem = both(run)
    assert refused == [] and len(bound) == 1 and bound[0][0]
    assert all(m == 5 for m in mem.values())


# --------------------------------------------------- release double-guard
def test_stale_generation_release_is_noop():
    def run(pkg):
        sched = make_sched(pkg, 2)
        cu = cu_of(pkg, 1)
        sched.submit(cu)
        first = [idxs for _, idxs in sched.try_schedule()]
        gen1 = sched.binding_gen(cu)
        sched.release(cu)                    # first (legitimate) release
        sched.submit(cu)                     # re-queued (retry path)
        second = [idxs for _, idxs in sched.try_schedule()]
        gen2 = sched.binding_gen(cu)
        sched.release(cu, gen=gen1)          # stale token: a no-op
        out = [first, second, gen2 != gen1, cu.uid in sched._running,
               sched.n_free]
        sched.release(cu)                    # current binding releases
        out.append(sched.n_free)
        sched.release(cu)                    # double release: no-op
        return out + [sched.n_free]
    _, _, new_gen, running, *free = both(run)
    assert new_gen and running and free == [1, 2, 2]


def test_speculation_loser_does_not_clobber_winner_result():
    def run(pkg):
        with _pm(pkg, 2) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=2))

            def fast(mesh=None):
                time.sleep(0.01)
                return "ok"

            for _ in range(3):
                pilot.submit(core.ComputeUnitDescription(
                    fn=fast, tag="clob", needs_mesh=False)).wait(30)
            gate = {"first": True}

            def racy(mesh=None):
                if gate["first"]:
                    gate["first"] = False
                    time.sleep(2.0)
                    return "stale-loser-value"
                return "winner"

            cu = pilot.submit(core.ComputeUnitDescription(
                fn=racy, tag="clob", needs_mesh=False))
            got = cu.wait(30)
            time.sleep(2.2)                  # let the loser thread come back
            return got, cu.result, pilot.agent.scheduler.n_free
    assert both(run) == ("winner", "winner", 2)


# ------------------------------------------------------- preemption safety
def test_preemption_victims_takes_its_own_lock():
    def run(pkg):
        sched = make_sched(pkg, 2)
        lows = [cu_of(pkg, 1), cu_of(pkg, 1)]
        for c in lows:
            sched.submit(c)
        for c, _ in sched.try_schedule():
            c._set_state(state(pkg, "RUNNING"))
        high = cu_of(pkg, 2, priority=5)
        victims = sched.preemption_victims(high, {c.uid: c for c in lows})
        return sorted(lows.index(next(c for c in lows if c.uid == v))
                      for v in victims)
    assert both(run) == [0, 1]


# --------------------------------------------------------- drain lifecycle
def test_begin_drain_stops_new_binds_and_finish_removes_slots():
    def run(pkg):
        sched = make_sched(pkg, 4)
        blocking = sched.begin_drain([2, 3])
        out = [blocking, sched.n_free, sched.n_slots]
        cu = cu_of(pkg, 4, gang=True)            # now too big for the pilot
        sched.submit(cu)
        sched.try_schedule()
        devs = sched.finish_drain([2, 3])
        return out + [cu.state.value, str(cu.error).replace(cu.uid, "<uid>"),
                      [d.i for d in devs], sched.n_slots,
                      2 in sched._mem_free]
    blocking, n_free, n_slots, cu_state, _, devs, n_slots2, kept = both(run)
    assert blocking == [] and n_free == 2 and n_slots == 2
    assert cu_state == "failed" and devs == [2, 3]
    assert n_slots2 == 2 and not kept


def test_shrink_under_load_requeues_onto_survivors():
    def run(pkg):
        with _pm(pkg, 4) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=4,
                                                    enable_speculation=False))
            cus = [pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: (time.sleep(0.15), 1)[1],
                n_chips=1, tag="shrink", needs_mesh=False))
                for _ in range(8)]
            time.sleep(0.05)                 # let the first wave bind
            devs = pilot.surrender_devices(2, preempt_after_s=0.0,
                                           timeout=10.0)
            return (len(devs), len(pilot.devices),
                    pilot.agent.scheduler.n_slots,
                    sum(cu.follow(30.0) for cu in cus), lease_events(pm))
    n_devs, n_left, n_slots, total, _ = both(run)
    assert (n_devs, n_left, n_slots, total) == (2, 2, 2, 8)


def test_grow_mid_run_binds_queued_gang():
    def run(pkg):
        with _pm(pkg, 4) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=2,
                                                    enable_speculation=False))
            blockers = [pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: time.sleep(1.5) or "blocked",
                n_chips=1, tag="blk", needs_mesh=False)) for _ in range(2)]
            time.sleep(0.05)
            gang = pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: len(mesh.devices.flat),
                n_chips=2, gang=True, tag="gang"))
            t0 = time.monotonic()
            pilot.absorb_devices(pm.rm.grant(2, pilot.uid))
            got = gang.wait(10.0)
            fast = time.monotonic() - t0 < 1.2   # bound on the NEW slots
            return (got, fast, [b.follow(10.0) for b in blockers],
                    lease_events(pm))
    got, fast, blocked, _ = both(run)
    assert got == 2 and fast and blocked == ["blocked"] * 2


# ------------------------------------------------------- gang reservations
def test_gang_reservation_prevents_starvation():
    def run(pkg):
        sched = make_sched(pkg, 2, gang_reservation_rounds=3)
        running, binds = [], []
        cus = []

        def feed_small():
            small = cu_of(pkg, 1)
            cus.append(small)
            sched.submit(small)

        feed_small()
        for c, idxs in sched.try_schedule():
            running.append(c)
            binds.append((cus.index(c), idxs))
        gang = cu_of(pkg, 2, gang=True)
        cus.append(gang)
        sched.submit(gang)
        bound_gang = False
        for _ in range(30):
            feed_small()                     # churn: a new small every round
            for c, idxs in sched.try_schedule():
                binds.append((cus.index(c), idxs))
                if c is gang:
                    bound_gang = True
                else:
                    running.append(c)
            if bound_gang:
                break
            if running:                      # finish the oldest small CU
                old = running.pop(0)
                old._set_state(state(pkg, "DONE"))
                sched.release(old)
        return bound_gang, binds, sched.stats["gang_reservations"]
    bound_gang, _, reservations = both(run)
    assert bound_gang, "gang CU starved behind small CUs"
    assert reservations >= 1


def test_gang_reservation_cleared_when_holder_cancels():
    def run(pkg):
        sched = make_sched(pkg, 2, gang_reservation_rounds=1)
        blocker = cu_of(pkg, 1)
        sched.submit(blocker)
        sched.try_schedule()
        gang = cu_of(pkg, 2, gang=True)
        sched.submit(gang)
        for _ in range(3):
            sched.try_schedule()             # ages into a reservation
        held = sched._gang_res_uid == gang.uid
        gang._set_state(state(pkg, "CANCELED"))
        sched.try_schedule()
        cleared = sched._gang_res_uid is None
        blocker._set_state(state(pkg, "DONE"))
        sched.release(blocker)
        return held, cleared, sched.n_free
    assert both(run) == (True, True, 2)     # nothing stuck in a dead resv


# ------------------------------------------------- heartbeats and pressure
def test_heartbeat_exports_backlog_metrics():
    def run(pkg):
        with _pm(pkg, 2) as (core, pm):
            pilot = pm.submit(core.PilotDescription(n_chips=2))
            pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: time.sleep(0.05), needs_mesh=False,
                tag="hb")).wait(30)
            hb = pilot.agent.heartbeat()
            return sorted(hb), hb["n_slots"], sorted(hb["ema_runtimes"])
    keys, n_slots, tags = both(run)
    assert {"free_chips", "n_slots", "queue_len", "queued_chip_demand",
            "busy_chips", "ema_runtimes"} <= set(keys)
    assert n_slots == 2 and "hb" in tags


# -------------------------------------------------- cross-pilot rebalance
def test_move_respects_running_gang_floor():
    def run(pkg):
        with _pm(pkg, 4, drain_preempt_after_s=0.0) as (core, pm):
            src = pm.submit(core.PilotDescription(n_chips=2, name="src",
                                                  enable_speculation=False))
            dst = pm.submit(core.PilotDescription(n_chips=2, name="dst",
                                                  enable_speculation=False))
            gang = src.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: time.sleep(0.3)
                or len(mesh.devices.flat), n_chips=2, gang=True,
                tag="gangwork"))
            time.sleep(0.05)                 # let it bind
            ev = pm.control_plane.move(src, dst, 1, reason="test")
            return (ev, len(src.devices), gang.follow(10.0),
                    lease_events(pm))
    ev, n_src, got, _ = both(run)
    assert ev is None and n_src == 2 and got == 2   # the gang survived


def test_balanced_pilots_do_not_thrash():
    def run(pkg):
        with _pm(pkg, 4, hysteresis=0.5) as (core, pm):
            pm.submit(core.PilotDescription(n_chips=2, name="a"))
            pm.submit(core.PilotDescription(n_chips=2, name="b"))
            return (pm.control_plane.rebalance(), pm.control_plane.events,
                    lease_events(pm))
    ev, events, _ = both(run)
    assert ev is None and events == []
