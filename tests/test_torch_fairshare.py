"""Parity of the port's multi-tenant scheduling with the JAX reference:
the 22 cases of tests/test_fairshare.py that had no mirror (the Session
tenant cases are in test_torch_session.py, the serve-budget cases in
test_torch_serving_engine.py).

Scheduler-level cases build the same ``FakeDevice`` pool for both
``YarnStyleScheduler``s; pilot-level cases run the reference on
``jax.devices() * n`` and the port on ``[torch.device("cpu")] * n``.
Each compares bind orders (submission index, device indices), victims,
per-queue charges, heartbeat dicts, ``RebalanceEvent`` fields (uids
mapped to pilot names, without ``t``) and error messages by equality.
Timing-dependent cases keep the reference's sleeps and bounds."""
import contextlib
import time

import jax
import pytest
import torch

import repro.core as jcore
import repro.core.compute_unit as jcu
import repro.core.queues as jq
import repro.core.scheduler as jsched
import repro_torch.core as tcore
import repro_torch.core.compute_unit as tcu
import repro_torch.core.queues as tq
import repro_torch.core.scheduler as tsched

CPU = torch.device("cpu")
CORE = {"ref": jcore, "port": tcore}
PACKAGES = {"ref": (jcu, jq, jsched), "port": (tcu, tq, tsched)}


class FakeDevice:
    def __init__(self, i):
        self.i = i
        self.type = self.platform = "fake"


def make_sched(pkg, n=4, hbm=16, queues=(), **kw):
    kw.setdefault("locality_delay_rounds", 0)
    if queues:
        kw["queues"] = qs(pkg, *queues)
    return PACKAGES[pkg][2].YarnStyleScheduler(
        [FakeDevice(i) for i in range(n)], hbm, **kw)


def qs(pkg, *specs):
    """QueueConfigs from (name, kwargs) pairs or bare names."""
    cfg = PACKAGES[pkg][1].QueueConfig
    return [cfg(s) if isinstance(s, str) else cfg(s[0], **s[1])
            for s in specs]


def cu_of(pkg, n_chips=1, *, gang=False, memory_bytes=0, priority=0,
          tenant=None, queue=None):
    cu_mod = PACKAGES[pkg][0]
    return cu_mod.ComputeUnit(cu_mod.ComputeUnitDescription(
        fn=lambda: None, n_chips=n_chips, gang=gang,
        memory_bytes=memory_bytes, priority=priority,
        tenant=tenant, queue=queue))


def state(pkg, name):
    return getattr(PACKAGES[pkg][0].CUState, name)


def drain_order(pkg, sched, cus, rounds=200):
    """Rounds to completion: [(submission index, device idxs)]."""
    order = []
    for _ in range(rounds):
        for cu, idxs in sched.try_schedule():
            order.append((cus.index(cu), idxs))
            cu._set_state(state(pkg, "DONE"))
            sched.release(cu)
        if len(order) >= len(cus):
            break
    return order


def index_of(cus, uids):
    return [next(i for i, c in enumerate(cus) if c.uid == u) for u in uids]


def used(sched, names):
    return {q: sched.queues.get(q).chips_used for q in names}


@contextlib.contextmanager
def _pm(pkg, n, **kw):
    core = CORE[pkg]
    devices = jax.devices() * n if pkg == "ref" else [CPU] * n
    pm = core.PilotManager(core.ResourceManager(devices=devices), **kw)
    try:
        yield core, pm
    finally:
        pm.shutdown()


def both(run):
    """One scenario on both packages; the outcomes must be equal."""
    ref, port = run("ref"), run("port")
    assert port == ref
    return ref


def raises(exc, match, fn, *args, **kw):
    """The message of the expected error (compared across packages)."""
    with pytest.raises(exc, match=match or None) as err:
        fn(*args, **kw)
    return str(err.value)


# ------------------------------------------------------- FIFO (the default)
def test_fifo_default_keeps_priority_then_arrival_order():
    def run(pkg):
        sched = make_sched(pkg, 1)
        cus = [cu_of(pkg, priority=p) for p in (0, 5, 2, 5, 2, 0)]
        for c in cus:
            sched.submit(c)
        return drain_order(pkg, sched, cus)
    assert [i for i, _ in both(run)] == [1, 3, 2, 4, 0, 5]


def test_fifo_ignores_queue_boundaries():
    def run(pkg):
        sched = make_sched(pkg, 1, queues=("a", "b"))
        cus = [cu_of(pkg, queue=q) for q in "aba"]
        for c in cus:
            sched.submit(c)
        return drain_order(pkg, sched, cus)
    assert [i for i, _ in both(run)] == [0, 1, 2]


# -------------------------------------------------------------------- DRF
def test_drf_dominant_share_convergence_three_tenants():
    def run(pkg):
        sched = make_sched(pkg, 12, policy="drf", queues=("a", "b", "c"))
        cus = [cu_of(pkg, queue=q) for q, n in (("a", 24), ("b", 4),
                                                ("c", 4)) for _ in range(n)]
        for c in cus:
            sched.submit(c)
        bound = sched.try_schedule()
        binds = [(cus.index(cu), idxs) for cu, idxs in bound]
        shares = used(sched, "abc")
        for cu, _ in bound:
            if cu.desc.queue != "a":
                cu._set_state(state(pkg, "DONE"))
                sched.release(cu)
        more = [(cus.index(cu), idxs) for cu, idxs in sched.try_schedule()]
        return binds, shares, more, used(sched, "abc")
    binds, shares, _, after = both(run)
    assert len(binds) == 12
    for q, n in shares.items():
        assert abs(n / 12 - 1 / 3) <= 0.1 * (1 / 3) + 1e-9, shares
    assert after["a"] == 12       # the heavy tenant absorbs the freed chips


def test_drf_weights_scale_fair_share():
    def run(pkg):
        sched = make_sched(pkg, 8, policy="drf",
                           queues=(("a", {"weight": 2.0}), "b", "c"))
        cus = [cu_of(pkg, queue=q) for q in "abc" for _ in range(8)]
        for c in cus:
            sched.submit(c)
        binds = [(cus.index(cu), idxs) for cu, idxs in sched.try_schedule()]
        return binds, used(sched, "abc")
    _, shares = both(run)
    assert shares == {"a": 4, "b": 2, "c": 2}


def test_drf_dominant_share_uses_both_dimensions():
    def run(pkg):
        queues = PACKAGES[pkg][1]
        tree = queues.QueueTree(qs(pkg, "m", "c"))
        tree.charge("m", 1, 160)     # HBM-heavy: 1 chip, 160 of 192 bytes
        tree.charge("c", 2, 0)       # chip-heavy
        totals = (12, 192)
        return (queues.DrfPolicy.dominant_share(tree.get("m"), totals),
                queues.DrfPolicy.dominant_share(tree.get("c"), totals),
                tree.snapshot())
    m, c, _ = both(run)
    assert (m, c) == (160 / 192, 2 / 12)


# --------------------------------------------------------------- capacity
def test_capacity_starved_guaranteed_queue_schedules_first():
    def run(pkg):
        sched = make_sched(pkg, 2, policy="capacity",
                           queues=(("prod", {"guaranteed_chips": 1}),
                                   "batch"))
        cus = [cu_of(pkg, queue="batch") for _ in range(3)]
        cus.append(cu_of(pkg, queue="prod"))
        for c in cus:
            sched.submit(c)
        return [(cus.index(cu), idxs) for cu, idxs in sched.try_schedule()]
    binds = both(run)
    assert 3 in [i for i, _ in binds] and len(binds) == 2


def test_capacity_elastic_borrowing_up_to_max():
    def run(pkg):
        sched = make_sched(pkg, 4, policy="capacity",
                           queues=(("prod", {"guaranteed_chips": 2}),
                                   ("batch", {"max_chips": 3})))
        cus = [cu_of(pkg, queue="batch") for _ in range(6)]
        for c in cus:
            sched.submit(c)
        binds = [(cus.index(cu), idxs) for cu, idxs in sched.try_schedule()]
        return binds, used(sched, ("prod", "batch")), sched.n_free
    _, shares, n_free = both(run)
    assert shares["batch"] == 3 and n_free == 1


def test_capacity_reclaim_victims_restore_guarantee():
    def run(pkg):
        sched = make_sched(pkg, 4, policy="capacity",
                           queues=(("prod", {"guaranteed_chips": 2}),
                                   ("batch", {"guaranteed_chips": 1})))
        batch = [cu_of(pkg, queue="batch", priority=p) for p in (3, 0, 1, 2)]
        for c in batch:
            sched.submit(c)
        for cu, _ in sched.try_schedule():
            cu._set_state(state(pkg, "RUNNING"))
        for _ in range(2):
            sched.submit(cu_of(pkg, queue="prod"))
        victims = sched.reclaim_victims({c.uid: c for c in batch})
        make_policy = PACKAGES[pkg][1].make_policy
        return (index_of(batch, victims),
                [make_policy(p).reclaims() for p in ("fifo", "drf",
                                                     "capacity")])
    victims, reclaims = both(run)
    assert victims == [1, 2]             # lowest priority first
    assert reclaims == [False, False, True]


def test_capacity_reclaim_through_agent_preemption():
    def run(pkg):
        with _pm(pkg, 4) as (core, pm):
            pilot = pm.submit(core.PilotDescription(
                n_chips=4, enable_speculation=False,
                scheduler_policy="capacity",
                queues=qs(pkg, ("prod", {"guaranteed_chips": 2}), "batch")))
            batch = [pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: time.sleep(0.8) or "b", n_chips=1,
                queue="batch", tag="batch", needs_mesh=False))
                for _ in range(4)]
            time.sleep(0.1)                  # batch occupies all 4 chips
            t0 = time.monotonic()
            prod = [pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: "p", n_chips=1, queue="prod",
                tag="prod", needs_mesh=False)) for _ in range(2)]
            got = [cu.follow(10.0) for cu in prod]
            # reclaim preempted borrowers instead of waiting 0.8 s out
            fast = time.monotonic() - t0 < 0.7
            reclaimed = pilot.agent.scheduler.stats.get(
                "capacity_reclaimed", 0) >= 1
            return got, fast, reclaimed, [cu.follow(10.0) for cu in batch]
    assert both(run) == (["p", "p"], True, True, ["b"] * 4)


# --------------------------------------- preemption honors queues + drains
def test_preemption_victims_respect_queue_guarantees():
    def run(pkg):
        sched = make_sched(pkg, 4, policy="capacity",
                           queues=(("prod", {"guaranteed_chips": 2}),
                                   "batch", "vip"))
        cus = ([cu_of(pkg, queue="prod") for _ in range(2)]
               + [cu_of(pkg, queue="batch") for _ in range(2)])
        for c in cus:
            sched.submit(c)
        for cu, _ in sched.try_schedule():
            cu._set_state(state(pkg, "RUNNING"))
        vip = cu_of(pkg, 2, priority=9, queue="vip")
        sched.submit(vip)
        return sorted(index_of(cus, sched.preemption_victims(
            vip, {c.uid: c for c in cus})))
    assert both(run) == [2, 3]           # only the batch CUs


def test_draining_device_never_chosen_as_preemption_target():
    def run(pkg):
        sched = make_sched(pkg, 2)
        cus = [cu_of(pkg), cu_of(pkg)]
        for c in cus:
            sched.submit(c)
        assignments = {}
        for cu, idxs in sched.try_schedule():
            cu._set_state(state(pkg, "RUNNING"))
            assignments[cus.index(cu)] = idxs
        sched.begin_drain([0])
        vip = cu_of(pkg, 1, priority=9)
        sched.submit(vip)
        victims = index_of(cus, sched.preemption_victims(
            vip, {c.uid: c for c in cus}))
        return assignments, victims
    assignments, victims = both(run)
    on_drain = next(i for i, idxs in assignments.items() if idxs == [0])
    assert victims == [1 - on_drain]


# ------------------------------------------------- ControlPlane guarantees
def test_controlplane_move_respects_queue_guarantee_floor():
    def run(pkg):
        with _pm(pkg, 8, drain_preempt_after_s=0.0) as (core, pm):
            src = pm.submit(core.PilotDescription(
                n_chips=4, name="src", enable_speculation=False,
                scheduler_policy="capacity",
                queues=qs(pkg, ("prod", {"guaranteed_chips": 3}))))
            dst = pm.submit(core.PilotDescription(n_chips=4, name="dst",
                                                  enable_speculation=False))
            cus = [src.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: time.sleep(0.25) or 1, n_chips=1,
                queue="prod", tag="prod", needs_mesh=False))
                for _ in range(8)]
            time.sleep(0.05)                 # guarantee is demand-backed
            floor = src.agent.scheduler.guarantee_floor()
            ev = pm.control_plane.move(src, dst, 4, reason="test")
            names = {src.uid: "src", dst.uid: "dst"}
            event = None if ev is None else (
                names[ev.src], names[ev.dst], ev.n_chips, ev.evicted,
                ev.reason)
            slots = src.agent.scheduler.n_slots
            again = pm.control_plane.move(src, dst, 4, reason="test")
            return (floor, event, slots, again,
                    src.agent.scheduler.n_slots,
                    sum(cu.follow(30.0) for cu in cus))
    floor, event, slots, again, slots2, total = both(run)
    assert floor == 3
    assert event is not None and event[2] == 1   # 4 - floor(3) may leave
    assert slots >= 3 and again is None and slots2 == 3 and total == 8


def test_idle_guarantee_does_not_pin_chips():
    def run(pkg):
        sched = make_sched(pkg, 4, policy="capacity",
                           queues=(("prod", {"guaranteed_chips": 3}),))
        idle = sched.guarantee_floor()
        sched.submit(cu_of(pkg, queue="prod"))
        return idle, sched.guarantee_floor()
    assert both(run) == (0, 1)           # demand-backed only


# ----------------------------------------------------- heartbeats and ACLs
def test_heartbeat_reports_per_queue_backlog():
    def run(pkg):
        with _pm(pkg, 2) as (core, pm):
            pilot = pm.submit(core.PilotDescription(
                n_chips=2, scheduler_policy="capacity",
                queues=qs(pkg, ("prod", {"guaranteed_chips": 1}))))
            pilot.submit(core.ComputeUnitDescription(
                fn=lambda mesh=None: 1, queue="prod", needs_mesh=False,
                tag="q")).wait(30)
            # the executor releases the chip just after DONE: wait for it
            deadline = time.monotonic() + 10
            while (pilot.agent.scheduler.n_free < 2
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            hb = pilot.agent.heartbeat()
            return (hb["queue_backlog"], hb["guarantee_floor"],
                    pm.control_plane.queue_pressures(hb))
    backlog, _, pressures = both(run)
    assert backlog["prod"]["guaranteed_chips"] == 1
    assert set(pressures) == set(backlog)


def test_declared_queues_reject_unknown_names():
    def run(pkg):
        sched = make_sched(pkg, 2, queues=(("prod", {"max_chips": 1}),))
        msgs = [raises(ValueError, "unknown queue", sched.submit,
                       cu_of(pkg, queue="prod2")),
                raises(ValueError, "untagged", sched.submit, cu_of(pkg))]
        capped = make_sched(pkg, 2, queues=("prod", ("default",
                                                     {"max_chips": 1})))
        capped.submit(cu_of(pkg))            # declared 'default' re-opens
        zero_conf = make_sched(pkg, 2)
        zero_conf.submit(cu_of(pkg, queue="anything"))   # auto-created
        return msgs, zero_conf.queues.get("anything") is not None, \
            capped.queues.snapshot()
    _, auto, _ = both(run)
    assert auto


def test_cap_impossible_cu_fails_fast():
    def run(pkg):
        sched = make_sched(pkg, 4, queues=(("small", {"max_chips": 2}),))
        cu = cu_of(pkg, 3, queue="small")
        sched.submit(cu)
        first = sched.try_schedule()
        out = [first, cu.state.value, str(cu.error).replace(cu.uid, "<uid>")]
        ok1, ok2 = cu_of(pkg, 2, queue="small"), cu_of(pkg, 2, queue="small")
        sched.submit(ok1)
        sched.submit(ok2)
        binds = [([ok1, ok2].index(c), idxs) for c, idxs
                 in sched.try_schedule()]
        return out + [binds, ok2.state.value]
    first, cu_state, msg, binds, ok2_state = both(run)
    assert first == [] and cu_state == "failed" and "max share" in msg
    assert len(binds) == 1 and ok2_state == "pending"


def test_cap_blocked_preemptor_evicts_only_its_own_queue():
    def run(pkg, gang_hog):
        sched = make_sched(pkg, 2, policy="capacity",
                           queues=(("capped", {"max_chips": 1}), "other"))
        low = cu_of(pkg, queue="other")
        hog = cu_of(pkg, queue="capped", gang=gang_hog)
        for c in (low, hog):
            sched.submit(c)
        for cu, _ in sched.try_schedule():
            cu._set_state(state(pkg, "RUNNING"))
        vip = cu_of(pkg, 1, priority=9, queue="capped")
        sched.submit(vip)
        return index_of([low, hog], sched.preemption_victims(
            vip, {low.uid: low, hog.uid: hog}))
    assert both(lambda pkg: run(pkg, False)) == [1]   # intra-queue: the hog
    assert both(lambda pkg: run(pkg, True)) == []     # no cross-queue stand-in


def test_cap_blocked_preemption_fires_even_with_free_chips():
    def run(pkg):
        sched = make_sched(pkg, 3, policy="capacity",
                           queues=(("capped", {"max_chips": 1}),))
        hog = cu_of(pkg, queue="capped")
        sched.submit(hog)
        for cu, _ in sched.try_schedule():
            cu._set_state(state(pkg, "RUNNING"))
        n_free = sched.n_free
        vip = cu_of(pkg, 1, priority=9, queue="capped")
        sched.submit(vip)
        return n_free, index_of([hog], sched.preemption_victims(
            vip, {hog.uid: hog}))
    assert both(run) == (2, [0])


def test_guaranteed_hbm_backs_the_chip_floor():
    def run(pkg):
        sched = make_sched(pkg, 4, hbm=16, policy="capacity",
                           queues=(("mem", {"guaranteed_hbm": 33}),))
        idle = sched.guarantee_floor()
        for _ in range(3):
            sched.submit(cu_of(pkg, queue="mem", memory_bytes=16))
        return idle, sched.guarantee_floor()
    assert both(run) == (0, 3)           # ceil(33 / 16) = 3 chips


def test_queue_acl_rejects_unauthorized_tenant():
    def run(pkg):
        sched = make_sched(pkg, 2, queues=(("secure",
                                            {"acl": frozenset({"alice"})}),))
        sched.submit(cu_of(pkg, queue="secure", tenant="alice"))   # allowed
        return [raises(PermissionError, "secure", sched.submit,
                       cu_of(pkg, queue="secure", tenant="bob")),
                raises(PermissionError, "", sched.submit,
                       cu_of(pkg, queue="secure")),           # anonymous
                sched.queues.snapshot()]
    both(run)


def test_mode1_carve_respects_queue_caps_and_charges_usage():
    def run(pkg):
        sched = make_sched(pkg, 4, queues=(("a", {"max_chips": 2}),
                                           "default"))
        take = sched.carve_out(2, queue="a")
        out = [take, sched.queues.get("a").chips_used,
               raises(RuntimeError, "max share", sched.carve_out, 1,
                      queue="a")]
        sched.restore(take)
        out.append(sched.queues.get("a").chips_used)
        memq = make_sched(pkg, 4, hbm=16, queues=(("m", {"max_hbm": 16}),))
        out.append(memq.carve_out(1, queue="m"))
        out.append(raises(RuntimeError, "HBM", memq.carve_out, 1, queue="m"))
        secured = make_sched(pkg, 2, queues=(("sec",
                                              {"acl": frozenset({"x"})}),))
        out.append(raises(PermissionError, "", secured.carve_out, 1,
                          queue="sec", tenant="y"))
        out.append(raises(ValueError, "untagged", secured.carve_out, 1))
        return out
    out = both(run)
    assert len(out[0]) == 2 and out[1] == 2 and out[3] == 0


def test_rejected_submit_leaves_no_zombie_cu_in_agent():
    def run(pkg):
        with _pm(pkg, 2) as (core, pm):
            pilot = pm.submit(core.PilotDescription(
                n_chips=2, queues=qs(pkg, "only")))
            msg = raises(ValueError, "unknown queue", pilot.submit,
                         core.ComputeUnitDescription(
                             fn=lambda: None, queue="typo",
                             needs_mesh=False))
            return msg, pilot.agent._cus
    assert both(run)[1] == {}
