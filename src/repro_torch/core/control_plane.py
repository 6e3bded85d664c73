"""ControlPlane: elastic cross-pilot device rebalancing.

The half of the paper's title that placement alone does not give —
*pilot-based dynamic resource management*.  The Session places stages
across pilots, but each
pilot's device slice was frozen at creation: a backlogged analytics
pilot starved while an idle HPC pilot held chips.  The ControlPlane,
owned by the :class:`PilotManager`, closes that loop:

  1. **poll** — every active pilot's Agent heartbeat (queue depth,
     queued chip demand, free chips, EMA runtimes) is folded into a
     scalar *pressure* = (queued chip demand + busy chips) / slots;
  2. **decide** — :meth:`rebalance` moves chips from the coldest pilot
     to the hottest when the pressure gap clears the hysteresis band
     (so near-balanced pilots do not thrash chips back and forth);
  3. **drain** — the cold pilot's scheduler marks the chips DRAINING
     (no new binds); its Agent waits for — or preempts and re-queues —
     the CUs running there (:meth:`Agent.service_drain`);
  4. **evict** — the shared DataPlane re-replicates every dataset with
     shards on the leaving chips onto the survivors, itemizing the
     bytes on the ledger (``reason="drain-evict"``), so named data
     survives the shrink;
  5. **reclaim/grant** — the lease moves through the ResourceManager's
     explicit lifecycle, and the hot pilot's Agent/Scheduler absorb the
     new slots live (queued gang CUs bind mid-run).

:meth:`grow` is the demand-paged variant the Session uses when a stage
is unplaceable: free exactly the deficit from the coldest pilots and
grant it to the chosen one.  ``in_flight`` exposes pending resizes so
the Session's placer never counts chips that are already leaving.

Run :meth:`start` for an autonomous polling loop, or call
:meth:`rebalance` from your own cadence (benchmarks do both).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .compute_unit import ComputeUnit, CUState
from .dataplane import Link, replicated_sharding

# pilot liveness states (Hadoop analogue: the RM's NM liveliness
# monitor).  ALIVE pilots heartbeat within the deadline; a SUSPECT
# pilot missed one deadline (maybe a GC pause — give it grace); a DEAD
# pilot missed deadline + grace and is recovered, never resurrected.
ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


@dataclasses.dataclass
class FailureEvent:
    """One detected pilot death and everything its recovery did."""
    t_detected: float
    t_recovered: float
    pilot: str                     # pilot uid declared DEAD
    reason: str
    requeued_cus: int              # in-flight CUs cloned onto survivors
    failed_cus: int                # CUs with nowhere left to go
    lost_datasets: List[str]       # names whose LAST replica died
    rematerialized: int            # of those, recovered via lineage
    orphan_micro_tasks: int        # Raptor tasks handed to survivors
    reclaimed_chips: int
    regranted: Dict[str, int]      # survivor uid -> chips absorbed
    serve_requests_recovered: int

    @property
    def recovery_s(self) -> float:
        """MTTR sample: detection -> recovery-complete."""
        return self.t_recovered - self.t_detected


@dataclasses.dataclass
class RebalanceEvent:
    """One completed chip movement (the audit record of a rebalance)."""
    t: float
    src: str                      # pilot uid the chips left
    dst: str                      # pilot uid that absorbed them
    n_chips: int
    evicted: Dict[str, int]       # dataset name -> bytes re-replicated
    reason: str

    @property
    def evicted_bytes(self) -> int:
        return sum(self.evicted.values())


class ControlPlane:
    # staging backlog -> pressure conversion: each queued/in-flight
    # transfer counts as a fraction of a chip of demand, so a pilot
    # drowning in stage-ins is not also handed more work
    STAGING_BACKLOG_WEIGHT = 0.25
    # each request waiting on a decode engine counts as a fraction of a
    # chip of demand: a pilot whose serving engines have deep admission
    # lines stops attracting additional batch work
    SERVE_BACKLOG_WEIGHT = 0.25

    def __init__(self, pm, *, hysteresis: float = 0.5,
                 min_chips: int = 1, max_move_fraction: float = 0.5,
                 min_keep: int = 1,
                 drain_preempt_after_s: float = 0.5,
                 drain_timeout_s: float = 30.0,
                 heartbeat_timeout_s: Optional[float] = None,
                 suspect_grace_s: Optional[float] = None,
                 redistribute_on_death: bool = True):
        self.pm = pm
        self.hysteresis = hysteresis
        self.min_chips = min_chips                  # never move fewer
        self.max_move_fraction = max_move_fraction  # ...or more per step
        self.min_keep = min_keep                    # chips a pilot keeps
        self.drain_preempt_after_s = drain_preempt_after_s
        self.drain_timeout_s = drain_timeout_s
        # failure detection: a pilot whose agent loop has not stamped
        # ``last_alive`` for heartbeat_timeout_s turns SUSPECT; after a
        # further suspect_grace_s (default: another timeout) it is DEAD
        # and recovered.  None disables detection (the default — pure
        # rebalancing deployments pay nothing for it).
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.suspect_grace_s = suspect_grace_s
        self.redistribute_on_death = redistribute_on_death
        self.liveness: Dict[str, str] = {}    # pilot uid -> ALIVE/SUSPECT/DEAD
        self._suspect_since: Dict[str, float] = {}
        self.failures: List[FailureEvent] = []
        # recovery hooks the Session wires up (kept as callables so the
        # core stays import-clean of the session/serve layers):
        #   on_data_loss(lost_names) -> rematerialized count
        #   on_orphan_tasks(tasks, survivors) -> resubmitted count
        #   on_pilot_dead: callables (pilot, survivors) -> recovered count
        self.on_data_loss: Optional[Callable[[List[str]], int]] = None
        self.on_orphan_tasks: Optional[Callable[[List, List], int]] = None
        self.on_pilot_dead: List[Callable[[Any, List], int]] = []
        self.in_flight: Dict[str, int] = {}   # pilot uid -> pending chip Δ
        self.events: List[RebalanceEvent] = []
        self.errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- polling
    def _active_pilots(self) -> List:
        return [p for p in self.pm.pilots
                if p.agent is not None and p.state.value == "active"]

    def _live_pilots(self) -> List:
        """Active pilots not under liveness suspicion — the only ones a
        rebalance may drain (draining a dead agent would hang until
        drain_timeout_s) or grant chips to."""
        return [p for p in self._active_pilots()
                if self.liveness.get(p.uid, ALIVE) == ALIVE]

    @classmethod
    def pressure_of(cls, hb: Dict[str, Any]) -> float:
        """Backlog pressure from one heartbeat: demanded + held chips
        plus a staging-backlog term (in-flight/queued transfers holding
        CUs under delay scheduling), normalized by the pilot's live
        slot count."""
        slots = max(hb.get("n_slots", 0), 1)
        demand = hb.get("queued_chip_demand", 0) + hb.get("busy_chips", 0)
        demand += (cls.STAGING_BACKLOG_WEIGHT
                   * hb.get("staging", {}).get("backlog", 0))
        demand += (cls.SERVE_BACKLOG_WEIGHT
                   * sum(s.get("waiting", 0)
                         for s in hb.get("serve", {}).values()))
        return demand / slots

    @staticmethod
    def queue_pressures(hb: Dict[str, Any]) -> Dict[str, float]:
        """Per-tenant-queue pressure from one heartbeat: each queue's
        demanded + held chips over the pilot's live slot count — the
        (pilot, queue) grid the multi-tenant rebalancer reasons about."""
        slots = max(hb.get("n_slots", 0), 1)
        return {name: (qb.get("queued_chip_demand", 0)
                       + qb.get("chips_used", 0)) / slots
                for name, qb in hb.get("queue_backlog", {}).items()}

    @staticmethod
    def estimate_drift(hb: Dict[str, Any]) -> Optional[float]:
        """How far the roofline placement model is off on this pilot:
        |log(EMA actual/estimate)| from the heartbeat's cross-check
        samples — 0.0 is a perfect model, ~0.7 is a 2x miss either way.
        None when the pilot has not run a cost-carrying stage yet."""
        ratio = hb.get("roofline", {}).get("ema_error_ratio")
        if ratio is None or ratio <= 0:
            return None
        return abs(math.log(ratio))

    def poll(self) -> Dict[str, Dict[str, Any]]:
        """Fresh heartbeat + pressure per active pilot (keyed by uid),
        with the per-queue pressure breakdown and the roofline
        estimate-drift cross-check."""
        out = {}
        for p in self._active_pilots():
            hb = p.agent.heartbeat()
            out[p.uid] = {**hb, "pressure": self.pressure_of(hb),
                          "queue_pressure": self.queue_pressures(hb),
                          "est_drift": self.estimate_drift(hb),
                          "pilot": p, "name": p.desc.name}
        return out

    def pending_delta(self, pilot_uid: str) -> int:
        """Chips in flight toward (+) or away from (−) a pilot; the
        Session's placer subtracts pending shrinks from capacity."""
        with self._lock:
            return self.in_flight.get(pilot_uid, 0)

    # ----------------------------------------------------- failure handling
    def liveness_of(self, pilot_uid: str) -> str:
        return self.liveness.get(pilot_uid, ALIVE)

    def check_failures(self, now: Optional[float] = None
                       ) -> List[FailureEvent]:
        """One liveness sweep (Hadoop analogue: the RM expiring an NM
        that missed its liveness interval).  A pilot whose agent loop
        has not stamped ``last_alive`` within ``heartbeat_timeout_s``
        turns SUSPECT; if a fresh beat lands during the grace window it
        is reprieved back to ALIVE, otherwise it is declared DEAD and
        :meth:`recover_pilot` runs.  Returns the FailureEvents produced
        this sweep."""
        if self.heartbeat_timeout_s is None:
            return []
        now = time.monotonic() if now is None else now
        grace = (self.suspect_grace_s if self.suspect_grace_s is not None
                 else self.heartbeat_timeout_s)
        recovered: List[FailureEvent] = []
        for p in self._active_pilots():
            age = now - p.agent.last_alive
            state = self.liveness.get(p.uid, ALIVE)
            if age <= self.heartbeat_timeout_s:
                if state == SUSPECT:          # reprieve: beat came back
                    self.liveness[p.uid] = ALIVE
                    self._suspect_since.pop(p.uid, None)
                continue
            if state == ALIVE:
                self.liveness[p.uid] = SUSPECT
                self._suspect_since[p.uid] = now
            elif state == SUSPECT and age > self.heartbeat_timeout_s + grace:
                recovered.append(self.recover_pilot(
                    p, reason=f"heartbeat missing {age:.2f}s"))
        return recovered

    def recover_pilot(self, pilot, *, reason: str = "failed"
                      ) -> FailureEvent:
        """Declare ``pilot`` DEAD and run the full recovery pipeline:

          1. serve/session hooks first (they need the replica map as the
             dead pilot left it, e.g. to spot spooled KV pages);
          2. Raptor overlay orphans handed to the on_orphan_tasks hook
             (or failed when nobody claims them);
          3. the DataPlane drops the pilot's replicas; names whose LAST
             replica died go to the on_data_loss hook (lineage remat);
          4. the device lease is reclaimed and — redistribute_on_death —
             regranted to the hottest survivor;
          5. every in-flight/queued CU is cloned onto a survivor
             (``CU.follow`` chases the chain) or FAILED with a
             diagnostic when no survivor can hold it.
        """
        t_detected = time.monotonic()
        self.liveness[pilot.uid] = DEAD
        self._suspect_since.pop(pilot.uid, None)
        agent = pilot.agent
        # make the crash total before recovering: a half-dead agent must
        # not publish results or beat while we requeue its work
        pilot.kill()
        pilot.mark_failed()
        survivors = self._live_pilots()

        # 1. serve/session recovery hooks (before the replica map mutates)
        serve_recovered = 0
        for hook in list(self.on_pilot_dead):
            try:
                serve_recovered += int(hook(pilot, survivors) or 0)
            except BaseException as e:  # noqa: BLE001 — recovery continues
                self.errors.append(e)

        # 2. orphaned Raptor micro-tasks
        orphans: List = []
        for master in agent.overlays():
            try:
                orphans.extend(master.orphans())
            except BaseException as e:  # noqa: BLE001
                self.errors.append(e)
        n_orphans = 0
        if orphans and self.on_orphan_tasks is not None:
            try:
                n_orphans = int(self.on_orphan_tasks(orphans, survivors) or 0)
            except BaseException as e:  # noqa: BLE001
                self.errors.append(e)
        else:
            for t in orphans:
                if not t.done:
                    t.error = RuntimeError(
                        f"overlay pilot {pilot.uid} died: {reason}")
                    t._finish()

        # 3. replica loss + lineage rematerialization
        lost = pilot.data.drop_pilot_replicas(pilot.uid)
        remat = 0
        if lost and self.on_data_loss is not None:
            try:
                remat = int(self.on_data_loss(lost) or 0)
            except BaseException as e:  # noqa: BLE001
                self.errors.append(e)

        # 4. lease reclaim + redistribution onto the hottest survivor
        n_chips = len(pilot.devices)
        self.pm.rm.release(pilot.uid)
        regranted: Dict[str, int] = {}
        if self.redistribute_on_death and survivors and n_chips:
            free = len(self.pm.rm.free_indices())
            n = min(n_chips, free)
            if n:
                target = max(
                    survivors,
                    key=lambda p: self.pressure_of(p.agent.heartbeat()))
                try:
                    granted = self.pm.rm.grant(n, target.uid)
                    target.absorb_devices(granted)
                    regranted[target.uid] = len(granted)
                except BaseException as e:  # noqa: BLE001
                    self.errors.append(e)

        # 5. requeue the dead pilot's CUs onto survivors (clone chains)
        requeued, failed = self._requeue_cus(pilot, survivors, reason)

        ev = FailureEvent(
            t_detected=t_detected, t_recovered=time.monotonic(),
            pilot=pilot.uid, reason=reason,
            requeued_cus=requeued, failed_cus=failed,
            lost_datasets=lost, rematerialized=remat,
            orphan_micro_tasks=n_orphans, reclaimed_chips=n_chips,
            regranted=regranted, serve_requests_recovered=serve_recovered)
        with self._lock:
            self.failures.append(ev)
        return ev

    def _requeue_cus(self, pilot, survivors: List, reason: str
                     ) -> "tuple[int, int]":
        """Clone every not-done CU of a dead pilot onto a survivor.
        Raptor master/extension CUs are canceled outright (the overlay's
        tasks were already recovered in step 2); speculative duplicates
        die with their pilot (the original still runs elsewhere)."""
        agent = pilot.agent
        with agent._lock:
            victims = [c for c in agent._cus.values() if not c.done]
        for cu in agent.scheduler.evacuate():
            if all(cu.uid != v.uid for v in victims):
                victims.append(cu)
        requeued = failed = 0
        for victim in victims:
            if victim.done:
                continue
            if (victim.desc.tag.startswith("raptor:")
                    or victim.speculative_of is not None):
                victim._set_state(CUState.CANCELED)
                continue
            placed: Optional[ComputeUnit] = None
            for target in sorted(survivors,
                                 key=lambda p: p.agent.scheduler.n_free,
                                 reverse=True):
                if target.agent.scheduler.n_slots < victim.desc.n_chips:
                    continue
                try:
                    placed = target.agent.submit(victim.desc)
                    break
                except (PermissionError, ValueError, KeyError) as e:
                    self.errors.append(e)
            if placed is not None:
                # publish the clone BEFORE canceling so follow() chases
                victim.result = placed
                victim._set_state(CUState.CANCELED)
                requeued += 1
            else:
                victim.error = RuntimeError(
                    f"{victim.uid} was in flight on {pilot.uid} when it "
                    f"died ({reason}) and no surviving pilot can hold "
                    f"{victim.desc.n_chips} chip(s)")
                victim._set_state(CUState.FAILED)
                failed += 1
        return requeued, failed

    # ------------------------------------------------------------ deciding
    def rebalance(self, max_chips: Optional[int] = None
                  ) -> Optional[RebalanceEvent]:
        """One control step: move idle chips from the coldest pilot to
        the hottest if the pressure gap clears the hysteresis band.
        Returns the event, or None when balanced (or nothing to move)."""
        # only ALIVE pilots participate: draining a SUSPECT/DEAD pilot
        # would block on an agent that will never answer
        snap = {uid: m for uid, m in self.poll().items()
                if self.liveness.get(uid, ALIVE) == ALIVE}
        if len(snap) < 2:
            return None
        hot = max(snap.values(), key=lambda m: m["pressure"])
        cold = min(snap.values(), key=lambda m: m["pressure"])
        if hot["pilot"].uid == cold["pilot"].uid:
            return None
        if hot["pressure"] - cold["pressure"] < self.hysteresis:
            return None
        step_cap = max(int(cold["n_slots"] * self.max_move_fraction),
                       self.min_chips)
        n = min(cold["free_chips"], step_cap,
                cold["n_slots"] - self.min_keep)
        if max_chips is not None:
            n = min(n, max_chips)
        if n < self.min_chips:
            return None
        return self.move(cold["pilot"], hot["pilot"], n, reason="pressure")

    def grow(self, pilot, n: int, *, reason: str = "unplaceable") -> int:
        """Free `n` chips from the coldest other pilots and grant them to
        `pilot` (the Session's unplaceable-stage path). Busy chips may be
        preempted by the drain. Returns chips actually granted."""
        granted = 0
        others = sorted((m for uid, m in self.poll().items()
                         if m["pilot"].uid != pilot.uid
                         and self.liveness.get(uid, ALIVE) == ALIVE),
                        key=lambda m: m["pressure"])
        for m in others:
            if granted >= n:
                break
            take = min(n - granted, m["n_slots"] - self.min_keep)
            if take < 1:
                continue
            ev = self.move(m["pilot"], pilot, take, reason=reason)
            if ev is not None:
                granted += ev.n_chips
        return granted

    # ------------------------------------------------------------- moving
    def move(self, src, dst, n: int, *,
             reason: str = "rebalance") -> Optional[RebalanceEvent]:
        """Drain `n` chips from `src`, evict their shards, walk the lease
        through reclaim → grant, and have `dst` absorb the slots live."""
        # never shrink below the largest gang the src pilot still owes
        # (a drain-preempted gang clone bigger than the shrunken pilot
        # would FAIL fast instead of waiting for chips that left), nor
        # below the chips its guaranteed tenant queues are entitled to —
        # a rebalance must not starve a queue's guaranteed share
        floor = max(src.agent.scheduler.max_gang_demand(),
                    src.agent.scheduler.guarantee_floor())
        if floor:
            n = min(n, max(src.agent.scheduler.n_slots - floor, 0))
        if n < 1:
            return None
        with self._lock:
            self.in_flight[src.uid] = self.in_flight.get(src.uid, 0) - n
            self.in_flight[dst.uid] = self.in_flight.get(dst.uid, 0) + n
        try:
            devs = src.surrender_devices(
                n, preempt_after_s=self.drain_preempt_after_s,
                timeout=self.drain_timeout_s)
            if not devs:
                return None
            # re-replicate shards off the leaving chips (or, if the pilot
            # is losing its whole slice, fall back to lineage recovery)
            if src.devices:
                sharding = replicated_sharding(src.devices)
                evicted = src.data.evict_devices(
                    devs, sharding, pilot=src.uid,
                    link=Link.ICI, reason="drain-evict")
            else:
                evicted = {}
                src.data.drop_pilot_replicas(src.uid)
            self.pm.rm.reclaim(src.uid, devs)
            granted = self.pm.rm.grant(len(devs), dst.uid)
            dst.absorb_devices(granted)
            ev = RebalanceEvent(t=time.monotonic(), src=src.uid, dst=dst.uid,
                                n_chips=len(granted), evicted=evicted,
                                reason=reason)
            with self._lock:
                self.events.append(ev)
            return ev
        finally:
            with self._lock:
                self.in_flight[src.uid] += n
                self.in_flight[dst.uid] -= n

    # ------------------------------------------------------------ overlays
    # Raptor overlays export backlog-per-worker through the heartbeat
    # ("overlays"); grow one when its queue is deep and chips are free,
    # shrink extensions back when it goes quiet.
    GROW_BACKLOG_PER_WORKER = 8.0
    SHRINK_BACKLOG_PER_WORKER = 1.0

    def scale_overlays(self,
                       snap: Optional[Dict[str, Dict[str, Any]]] = None
                       ) -> Dict[str, int]:
        """One overlay-elasticity step over every active pilot: for each
        Raptor overlay in the heartbeat, grow (+1 worker-extension CU,
        if the pilot has a free chip) when pending/worker exceeds
        GROW_BACKLOG_PER_WORKER, shrink one extension when it falls
        under SHRINK_BACKLOG_PER_WORKER.  Returns overlay name -> worker
        delta applied."""
        snap = snap if snap is not None else self.poll()
        deltas: Dict[str, int] = {}
        for uid, m in snap.items():
            if self.liveness.get(uid, ALIVE) != ALIVE:
                continue
            pilot = m["pilot"]
            for master in pilot.agent.overlays():
                ov = m.get("overlays", {}).get(master.uid)
                if ov is None or not master.alive:
                    continue
                bpw = ov.get("backlog_per_worker", 0.0)
                if (bpw > self.GROW_BACKLOG_PER_WORKER
                        and m.get("free_chips", 0) > 0):
                    master.grow(1)
                    deltas[master.uid] = deltas.get(master.uid, 0) + 1
                elif bpw < self.SHRINK_BACKLOG_PER_WORKER:
                    shrunk = master.shrink(1)
                    if shrunk:
                        deltas[master.uid] = deltas.get(master.uid, 0) - shrunk
        return deltas

    # ---------------------------------------------------------- autonomous
    def start(self, interval_s: float = 0.25) -> None:
        """Poll-and-rebalance on a daemon thread until :meth:`stop`."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, args=(interval_s,),
                                        daemon=True, name="control-plane")
        self._thread.start()

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.check_failures()
                self.rebalance()
                self.scale_overlays()
            except BaseException as e:  # noqa: BLE001 — keep the loop alive
                self.errors.append(e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ---------------------------------------------------------------- info
    def moved_chips(self) -> int:
        with self._lock:
            return sum(e.n_chips for e in self.events)
