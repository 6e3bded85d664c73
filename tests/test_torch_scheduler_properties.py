"""Parity of the port's YARN-style scheduler with the JAX reference under
the hypothesis properties of tests/test_scheduler_properties.py.

Each draw feeds the same submissions to ``repro.core.scheduler`` and
``repro_torch.core.scheduler`` over equal ``FakeDevice`` pools: the bind
sequences (submission index, device indices) must be equal, and each
package must keep the reference's invariants."""
import pytest
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

import repro.core.compute_unit as jcu
import repro.core.scheduler as jsched

import repro_torch.core.compute_unit as tcu
import repro_torch.core.scheduler as tsched

PACKAGES = {"ref": (jcu, jsched), "port": (tcu, tsched)}


class FakeDevice:
    def __init__(self, i):
        self.i = i
        self.type = self.platform = "fake"


def make_sched(pkg, n=8, hbm=16, reuse=True):
    return PACKAGES[pkg][1].YarnStyleScheduler(
        [FakeDevice(i) for i in range(n)], hbm, reuse_app_master=reuse,
        locality_delay_rounds=0)


def cu_of(pkg, **kw):
    cu_mod = PACKAGES[pkg][0]
    return cu_mod.ComputeUnit(cu_mod.ComputeUnitDescription(
        fn=lambda: None, **kw))


def drain(pkg, sched, cus):
    """Rounds to a fixed point, releasing as we go: [(index, idxs)]."""
    done_state = PACKAGES[pkg][0].CUState.DONE
    done = []
    for _ in range(1000):
        bound = sched.try_schedule()
        if not bound:
            break
        for cu, idxs in bound:
            done.append((cus.index(cu), list(idxs)))
            cu._set_state(done_state)
            sched.release(cu)
    return done


def both(run, *args):
    """Run one scenario on both packages; their outcomes must be equal."""
    ref, port = run("ref", *args), run("port", *args)
    assert port == ref
    return ref


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 8), st.booleans()), min_size=1,
                max_size=30))
def test_all_feasible_cus_eventually_schedule(reqs):
    def run(pkg):
        sched = make_sched(pkg, 8)
        cus = [cu_of(pkg, n_chips=chips, gang=gang) for chips, gang in reqs]
        for cu in cus:
            sched.submit(cu)
        return drain(pkg, sched, cus), sched.n_free
    done, n_free = both(run)
    assert len(done) == len(reqs)
    assert n_free == 8


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 8), min_size=1, max_size=20),
       st.integers(1, 8))
def test_no_slot_oversubscription(chip_reqs, n_devices):
    def run(pkg):
        done_state = PACKAGES[pkg][0].CUState.DONE
        sched = make_sched(pkg, n_devices)
        cus = [cu_of(pkg, n_chips=c) for c in chip_reqs if c <= n_devices]
        for cu in cus:
            sched.submit(cu)
        in_flight, binds = [], []
        for _ in range(200):
            bound = sched.try_schedule()
            for cu, idxs in bound:
                assert len(idxs) == cu.desc.n_chips
                in_flight.append((cu, set(idxs)))
                binds.append((cus.index(cu), list(idxs)))
            all_idxs = [i for _, s in in_flight for i in s]
            assert len(all_idxs) == len(set(all_idxs)), "device double-booked"
            assert len(all_idxs) + sched.n_free == n_devices
            if in_flight:
                cu, _ = in_flight.pop(0)
                cu._set_state(done_state)
                sched.release(cu)
            elif not bound:
                break
        return binds, sched.n_free
    _, n_free = both(run)
    assert n_free == n_devices


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 100), min_size=2, max_size=12))
def test_priority_respected_within_round(priorities):
    def run(pkg):
        done_state = PACKAGES[pkg][0].CUState.DONE
        sched = make_sched(pkg, 1)
        cus = [cu_of(pkg, n_chips=1, priority=p) for p in priorities]
        for cu in cus:
            sched.submit(cu)
        order = []
        for _ in range(len(cus) * 3):
            for cu, idxs in sched.try_schedule():
                order.append((cus.index(cu), list(idxs)))
                cu._set_state(done_state)
                sched.release(cu)
            if len(order) == len(cus):
                break
        return order
    order = both(run)
    assert [priorities[i] for i, _ in order] == sorted(priorities,
                                                       reverse=True)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 8), st.integers(0, 7))
def test_device_removal_keeps_accounting(n, n_remove):
    n_remove = min(n_remove, n)

    def run(pkg):
        sched = make_sched(pkg, n)
        impacted = sched.remove_devices(list(range(n_remove)))
        out = [impacted, sched.n_free]
        if n - n_remove > 0:
            cu = cu_of(pkg, n_chips=n - n_remove)
            sched.submit(cu)
            out.append(drain(pkg, sched, [cu]))
        return out
    out = both(run)
    assert out[1] == n - n_remove
    if n - n_remove > 0:
        assert len(out[2]) == 1


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(1, 4), min_size=1, max_size=10))
def test_memory_slots_respected(mem_reqs):
    hbm = 16

    def run(pkg):
        sched = make_sched(pkg, 2, hbm=hbm)
        cus = [cu_of(pkg, n_chips=1, memory_bytes=m) for m in mem_reqs]
        for cu in cus:
            sched.submit(cu)
        return [(cus.index(cu), list(idxs))
                for cu, idxs in sched.try_schedule()]
    bound = both(run)
    used = {}
    for i, idxs in bound:
        for d in idxs:
            used[d] = used.get(d, 0) + mem_reqs[i]
    assert all(u <= hbm for u in used.values())
