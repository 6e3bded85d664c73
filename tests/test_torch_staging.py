"""Parity of the port's tiered data staging with the JAX reference: the
17 cases of tests/test_staging.py that had no mirror (the two Session
cases are in test_torch_session.py).

Scheduler-level cases (delay scheduling) build the same ``FakeDevice``
pool for both ``YarnStyleScheduler``s; pilot-level cases run the
reference on ``jax.devices() * n`` and the port on
``[torch.device("cpu")] * n``, with one shared DataPlane each.  Each
compares ``StageRequest`` states and wire bytes, ``DataPlane`` ledgers
(by ``Link`` and by reason string, uids mapped to names), replica homes,
prefetcher and cache stats and landed values by equality."""
import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.compute_unit as jcu
import repro.core.control_plane as jcp
import repro.core.dataplane as jdp
import repro.core.scheduler as jsched
import repro.core.staging as jstaging
import repro_torch.core as tcore
import repro_torch.core.compute_unit as tcu
import repro_torch.core.control_plane as tcp
import repro_torch.core.dataplane as tdp
import repro_torch.core.scheduler as tsched
import repro_torch.core.staging as tstaging

CPU = torch.device("cpu")
CORE = {"ref": jcore, "port": tcore}
DATAPLANE = {"ref": jdp, "port": tdp}
PACKAGES = {"ref": (jcu, jsched, jstaging), "port": (tcu, tsched, tstaging)}


class FakeDevice:
    def __init__(self, i):
        self.i = i
        self.type = self.platform = "fake"


def make_sched(pkg, n=4, hbm=16, **kw):
    kw.setdefault("locality_delay_rounds", 0)
    return PACKAGES[pkg][1].YarnStyleScheduler(
        [FakeDevice(i) for i in range(n)], hbm, **kw)


def request(pkg, name):
    staging = PACKAGES[pkg][2]
    return staging.StageRequest(staging.DataRef(name))


def cu_with_staging(pkg, reqs, n_chips=1):
    cu_mod = PACKAGES[pkg][0]
    cu = cu_mod.ComputeUnit(cu_mod.ComputeUnitDescription(
        fn=lambda: None, n_chips=n_chips))
    cu.staging_futures = list(reqs)
    return cu


class World:
    """A PilotManager over one shared DataPlane, with `n_pilots` pilots
    named p0, p1, ...; uids in ledgers and homes read as names."""

    def __init__(self, pkg, pm, data, pilots):
        self.pkg, self.pm, self.data, self.pilots = pkg, pm, data, pilots
        self.names = {p.uid: p.desc.name for p in pilots}

    def put_on(self, name, pilot, elems=1024):
        sharding = DATAPLANE[self.pkg].replicated_sharding(pilot.devices)
        if self.pkg == "ref":
            arr = jax.device_put(jnp.ones((elems,), jnp.float32), sharding)
        else:
            arr = tdp.place(torch.ones(elems), sharding)
        self.data.put(name, arr, pilot=pilot.uid)
        return arr

    def host(self, name):
        arr = self.data.get(name).array
        return np.asarray(arr) if self.pkg == "ref" else arr.to_numpy()

    def homes(self, name):
        return sorted(self.names.get(h, h)
                      for h in self.data.home_pilots(name))

    def ledger(self):
        led = self.data.ledger()
        pattern = re.compile("|".join([r"cu-\d+"] + [re.escape(u)
                                                     for u in self.names]))

        def clean(reason):
            return pattern.sub(lambda m: self.names.get(m[0], "<cu>"),
                               reason)
        return {**led, "by_reason": {clean(k): v for k, v
                                     in led["by_reason"].items()}}


@contextlib.contextmanager
def make_pilots(pkg, n_pilots=2, n_chips=2, **desc_kw):
    core = CORE[pkg]
    n = n_pilots * n_chips
    devices = jax.devices() * n if pkg == "ref" else [CPU] * n
    shared = core.DataPlane()
    pm = core.PilotManager(core.ResourceManager(devices=devices))
    try:
        pilots = [pm.submit(core.PilotDescription(
            n_chips=n_chips, name=f"p{i}", enable_speculation=False,
            **desc_kw), data_registry=shared) for i in range(n_pilots)]
        yield World(pkg, pm, shared, pilots)
    finally:
        pm.shutdown()


def both(run):
    """One scenario on both packages; the outcomes must be equal."""
    ref, port = run("ref"), run("port")
    assert port == ref
    return ref


# ------------------------------------------------------- delay scheduling
def test_delay_scheduling_is_bounded():
    def run(pkg):
        sched = make_sched(pkg, 2, staging_delay_rounds=3)
        req = request(pkg, "x")               # never resolves
        cu = cu_with_staging(pkg, [req])
        sched.submit(cu)
        held = [sched.schedule_round() for _ in range(3)]
        bound = [(b[0] is cu, b[1]) for b in sched.schedule_round()]
        return (held, bound, sched.stats["staging_delayed"],
                sched.stats["staging_expired"], req.state.value)
    held, bound, delayed, expired, _ = both(run)
    assert held == [[], [], []] and [b for b, _ in bound] == [True]
    assert (delayed, expired) == (3, 1)


def test_delay_scheduling_binds_early_when_staging_lands():
    def run(pkg):
        sched = make_sched(pkg, 2, staging_delay_rounds=100)
        req = request(pkg, "x")
        cu = cu_with_staging(pkg, [req])
        sched.submit(cu)
        held = sched.schedule_round()
        req._resolve(PACKAGES[pkg][2].StageState.DONE, 0)   # landed
        bound = [(b[0] is cu, b[1]) for b in sched.schedule_round()]
        return held, bound, sched.stats["staging_expired"]
    held, bound, expired = both(run)
    assert held == [] and [b for b, _ in bound] == [True] and expired == 0


def test_staging_does_not_block_other_cus():
    def run(pkg):
        sched = make_sched(pkg, 2, staging_delay_rounds=100)
        waiting = cu_with_staging(pkg, [request(pkg, "x")])
        ready = cu_with_staging(pkg, [])
        sched.submit(waiting)
        sched.submit(ready)
        return [([waiting, ready].index(b[0]), b[1])
                for b in sched.schedule_round()]
    assert [i for i, _ in both(run)] == [1]     # a skip, not a barrier


# ------------------------------------------------------------- LRU cache
def test_lru_cache_never_drops_last_replica():
    def run(pkg):
        with make_pilots(pkg, n_pilots=1) as w:
            p0 = w.pilots[0]
            w.put_on("only", p0)              # single replica, on p0
            cache = PACKAGES[pkg][2].ReplicaCache(p0.uid, w.data,
                                                  budget_bytes=1)
            first = cache.admit("only", w.data.get("only").nbytes)
            second = cache.admit("other", 10**9)   # an eviction walk
            return (first, second, "only" in w.data,
                    w.data.resident_on("only", p0.uid), cache.stats,
                    "only" in cache, w.homes("only"))
    _, _, survived, resident, stats, cached, _ = both(run)
    assert survived and resident
    assert stats["evictions"] == 0 or cached


def test_lru_cache_evicts_in_recency_order_within_budget():
    def run(pkg):
        with make_pilots(pkg) as w:
            p0, p1 = w.pilots
            nbytes = 1024 * 4
            for name in ("a", "b", "c"):
                w.put_on(name, p0)            # home p0 (evictable on p1)
                w.data.replicate_to(name, p1.uid, DATAPLANE[pkg]
                                    .replicated_sharding(p1.devices))
            cache = PACKAGES[pkg][2].ReplicaCache(p1.uid, w.data,
                                                  budget_bytes=2 * nbytes)
            cache.admit("a", nbytes)
            cache.admit("b", nbytes)
            cache.touch("a")                  # b is now LRU
            evicted = cache.admit("c", nbytes)
            return (evicted, w.homes("b"), cache.bytes_cached, cache.stats,
                    w.ledger())
    evicted, homes_b, cached, _, _ = both(run)
    assert evicted == ["b"]
    assert homes_b == ["p0"]                  # dropped on p1, kept on p0
    assert cached == 2 * 1024 * 4


# ------------------------------------------------------------ prefetcher
def test_prefetch_transfers_and_ledgers():
    def run(pkg):
        with make_pilots(pkg) as w:
            p0, p1 = w.pilots
            w.put_on("x", p0)
            (req,) = p1.stage_in(["x"])
            return (req.wait(10.0), req.state.value, w.homes("x"),
                    w.ledger(), w.data.get("x").nbytes)
    wire, req_state, homes, ledger, nbytes = both(run)
    assert wire == nbytes and req_state == "done"
    assert homes == ["p0", "p1"]              # replica ADDED, not moved
    assert ledger["by_link"]["dcn"] == nbytes


def test_prefetch_hit_skips_transfer_and_ledger():
    def run(pkg):
        with make_pilots(pkg) as w:
            p0, p1 = w.pilots
            w.put_on("x", p1)                 # already resident on p1
            (req,) = p1.stage_in(["x"])
            return (req.wait(10.0), req.hit, req.state.value,
                    p1.prefetcher.cache.stats["hits"], w.ledger())
    wire, hit, _, hits, ledger = both(run)
    assert wire == 0 and hit and hits == 1 and ledger["by_link"]["dcn"] == 0


def test_duplicate_requests_coalesce_to_one_transfer():
    def run(pkg):
        with make_pilots(pkg) as w:
            p0, p1 = w.pilots
            w.put_on("x", p0)
            reqs = p1.stage_in(["x", "x", "x"])
            wires = sorted(r.wait(10.0) for r in reqs)
            snap = p1.prefetcher.snapshot()
            return (wires, snap["transfers"], snap["cache"]["hits"],
                    w.ledger(), w.data.get("x").nbytes)
    wires, transfers, hits, ledger, nbytes = both(run)
    assert wires == [0, 0, nbytes] and transfers == 1 and hits == 2
    assert ledger["by_link"]["dcn"] == nbytes


def test_remote_read_claim_ledgers_and_resolves():
    def run(pkg):
        with make_pilots(pkg) as w:
            p0, p1 = w.pilots
            w.put_on("x", p0)
            req = request(pkg, "x")           # never enqueued: PENDING
            first = p1.prefetcher.claim_remote(req)
            out = [first, req.state.value, req.done, w.ledger()]
            second = p1.prefetcher.claim_remote(req)
            return out + [second, w.ledger(), w.data.get("x").nbytes]
    first, req_state, done, led1, second, led2, nbytes = both(run)
    assert first and req_state == "remote" and done and not second
    assert led1["by_link"]["dcn"] == led2["by_link"]["dcn"] == nbytes


def test_stage_out_spools_to_gfs_archive():
    def run(pkg):
        with make_pilots(pkg) as w:
            p0, _ = w.pilots
            w.put_on("out", p0)
            (req,) = p0.prefetcher.request_many(["out"], kind="out")
            return (req.wait(10.0), req.state.value, w.ledger(),
                    w.homes("out"), w.data.get("out").nbytes)
    nbytes, _, ledger, homes, want = both(run)
    assert nbytes == want and ledger["by_link"]["gfs"] == nbytes
    assert homes == ["@gfs", "p0"]            # archive noted, pilot kept


def test_stage_in_via_cu_description_and_heartbeat_export():
    def run(pkg):
        core = CORE[pkg]
        with make_pilots(pkg) as w:
            p0, p1 = w.pilots
            w.put_on("x", p0)
            cu = p1.submit(core.ComputeUnitDescription(
                fn=lambda: 42, n_chips=1, needs_mesh=False,
                stage_in=("x",)))
            got = cu.wait(30.0)
            hb = p1.agent.heartbeat()
            return (got, [(r.done, r.state.value, r.wire_bytes)
                          for r in cu.staging_futures], w.homes("x"),
                    hb["staging"]["requests"], hb["staging"]["backlog"],
                    w.ledger())
    got, reqs, homes, n_req, backlog, _ = both(run)
    assert got == 42 and all(done for done, *_ in reqs)
    assert "p1" in homes and (n_req, backlog) == (1, 0)


def test_pressure_folds_staging_backlog():
    hb = {"n_slots": 4, "queued_chip_demand": 0, "busy_chips": 0,
          "staging": {"backlog": 8}}
    base = dict(hb, staging={"backlog": 0})
    ref = jcp.ControlPlane
    port = tcp.ControlPlane
    assert port.STAGING_BACKLOG_WEIGHT == ref.STAGING_BACKLOG_WEIGHT
    assert port.pressure_of(hb) == ref.pressure_of(hb)
    assert port.pressure_of(base) == ref.pressure_of(base)
    assert port.pressure_of(hb) > port.pressure_of(base)
    assert port.pressure_of(hb) == pytest.approx(
        port.STAGING_BACKLOG_WEIGHT * 8 / 4)


# ------------------------------------------------------- wire compression
def test_compressed_replicate_ledgers_quarter_bytes():
    def run(pkg):
        staging = PACKAGES[pkg][2]
        with make_pilots(pkg) as w:
            p0, p1 = w.pilots
            w.put_on("big", p0, elems=64 * 1024)   # 256 KiB of f32
            (req,) = p1.stage_in([staging.DataRef("big", compress="int8")])
            wire = req.wait(10.0)
            return (wire, w.data.compressed_bytes_saved, w.ledger(),
                    w.host("big"))
    ref, port = run("ref"), run("port")
    assert port[:3] == ref[:3]
    np.testing.assert_array_equal(port[3], ref[3])
    wire, saved, ledger, landed = ref
    nbytes = 64 * 1024 * 4
    assert wire == pytest.approx(nbytes / 4, rel=0.01)
    assert saved == nbytes - wire and ledger["by_link"]["dcn"] == wire
    np.testing.assert_allclose(landed, np.ones_like(landed), atol=0.01)


def test_small_transfers_skip_compression():
    def run(pkg):
        staging = PACKAGES[pkg][2]
        with make_pilots(pkg) as w:
            p0, p1 = w.pilots
            w.put_on("small", p0, elems=64)        # far below 64 KiB
            (req,) = p1.stage_in([staging.DataRef("small", compress="int8")])
            return (req.wait(10.0), w.data.compressed_bytes_saved,
                    w.ledger())
    wire, saved, _ = both(run)
    assert wire == 64 * 4 and saved == 0           # full-fat wire


# ------------------------------------------------------- link validation
def test_record_moved_rejects_unknown_link():
    msgs = []
    for core in (jcore, tcore):
        with pytest.raises(ValueError, match="ici.*dcn.*gfs") as err:
            core.DataPlane().record_moved(100, "infiniband")
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_cost_model_rejects_unknown_link():
    msgs = []
    for core in (jcore, tcore):
        with pytest.raises(ValueError, match="valid links") as err:
            core.TransferCostModel().cost_per_byte("nvlink")
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_prefetcher_stop_fails_queued_requests():
    def run(pkg):
        with make_pilots(pkg, n_pilots=1) as w:
            p0 = w.pilots[0]
            w.put_on("x", p0)
            p0.prefetcher.stop()
            req = request(pkg, "x")
            p0.prefetcher._q.put((0, 0, req))
            p0.prefetcher.stop()
            with pytest.raises(RuntimeError, match="stopped") as err:
                req.wait(1.0)
            return req.state.value, str(err.value), w.ledger()
    req_state, _, _ = both(run)
    assert req_state == "failed"
