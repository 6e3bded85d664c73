"""YARN-style application-level scheduler for a Pilot's device slice.

Mirrors the paper's description of resource management on YARN:
  * slots are (chips, HBM-bytes) pairs — the scheduler tracks both, like
    YARN's (vcores, memory) DominantResourceCalculator;
  * two-phase admission: an AppMaster reservation precedes container
    binding (the paper measures this as the dominant CU-startup cost);
    ``reuse_app_master=True`` amortizes phase 1 across CUs of the same
    app — the paper's stated future optimization, implemented here;
  * gang scheduling: HPC-stage CUs get all requested chips atomically or
    wait (what YARN could not do, motivating Mode II); a gang CU that
    waits too long gets an aging *reservation* — freed chips are parked
    for it instead of leaking to smaller CUs (YARN's container
    reservations, which stop large requests starving behind small ones);
  * data locality: candidate device sets are scored against the CU's
    PilotData placement; scheduling is delayed up to
    ``locality_delay_rounds`` in the hope a local slot frees up (YARN's
    delay scheduling), after which it falls back to any slot;
  * elasticity: devices can be carved out (Mode-I analytics clusters,
    :meth:`carve_out`/:meth:`restore`), marked DRAINING for a
    ControlPlane rebalance (:meth:`begin_drain`/:meth:`finish_drain` —
    no new binds, running CUs finish or are preempted), or added live
    (:meth:`add_devices`);
  * multi-tenancy: pending CUs live in a :class:`~repro_torch.core.queues.
    QueueTree` of named tenant queues with guaranteed/maximum (chips,
    HBM) shares; a pluggable :class:`~repro_torch.core.queues.
    SchedulingPolicy` (``fifo`` — the default, byte-for-byte the old
    single-list order — ``capacity`` or ``drf``) arbitrates between
    queues each round, preemption respects queue guarantees, and a
    starved guaranteed queue reclaims borrowed chips via
    :meth:`reclaim_victims`.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

from .compute_unit import ComputeUnit, CUState
from .dataplane import DataPlane
from .queues import (DEFAULT_QUEUE, QueueConfig, QueueTree, SchedulingPolicy,
                     make_policy)

APP_MASTER_CHIPS = 1  # phase-1 reservation size (YARN AppMaster container)


def mem_per_chip(memory_bytes: Optional[int], n_chips: int) -> int:
    """Per-chip HBM share of a CU's memory request, rounded UP.

    Floor division dropped the remainder, so an n-chip CU asking for
    ``m`` bytes was admitted against only ``n * (m // n)`` — chips could
    oversubscribe by up to ``n - 1`` bytes per CU. Ceil keeps admission
    and release symmetric and never under-accounts.
    """
    return -((memory_bytes or 0) // -max(n_chips, 1))


class YarnStyleScheduler:
    def __init__(self, devices: Sequence, hbm_per_chip: int,
                 data_registry: Optional[DataPlane] = None, *,
                 reuse_app_master: bool = True,
                 locality_delay_rounds: int = 3,
                 staging_delay_rounds: int = 8,
                 app_master_overhead_s: float = 0.0,
                 gang_reservation_rounds: int = 8,
                 policy: Union[str, SchedulingPolicy, None] = "fifo",
                 queues: Optional[Sequence[QueueConfig]] = None):
        self._devices = list(devices)
        self._hbm = hbm_per_chip
        self._free: Set[int] = set(range(len(self._devices)))
        self._mem_free: Dict[int, int] = {i: hbm_per_chip
                                          for i in range(len(self._devices))}
        self.policy = make_policy(policy)
        self.queues = QueueTree(queues, hbm_per_chip=hbm_per_chip)
        self._cu_usage: Dict[str, Tuple[str, int, int]] = {}  # uid -> (q, chips, hbm)
        self._running: Dict[str, List[int]] = {}
        self._app_masters: Dict[str, int] = {}     # app_id -> device idx
        self._skip_counts: Dict[str, int] = {}
        # staging delay scheduling: rounds a CU has been held waiting
        # for its stage_in transfers to land (bounded by
        # staging_delay_rounds, then it runs with remote reads)
        self._staging_waits: Dict[str, int] = {}
        # --- elastic device states (disjoint from _free) ---
        self._draining: Set[int] = set()    # no new binds; leaving the pilot
        self._carved: Set[int] = set()      # Mode-I carve-out (will return)
        self._carved_charge: Dict[int, Tuple[str, int]] = {}  # idx -> (q, hbm)
        # --- gang reservation (aging): freed chips park for one starved gang
        self._gang_res_uid: Optional[str] = None
        self._gang_res_chips: Set[int] = set()
        self._gang_res_need: int = 0
        self._gang_waits: Dict[str, int] = {}
        self._running_gangs: Dict[str, int] = {}  # uid -> gang size
        # --- binding generations guard stale releases (retry/speculation)
        self._bound_gen: Dict[str, int] = {}
        self._gen = itertools.count(1)
        self.reuse_app_master = reuse_app_master
        self.locality_delay_rounds = locality_delay_rounds
        self.staging_delay_rounds = staging_delay_rounds
        self.app_master_overhead_s = app_master_overhead_s
        self.gang_reservation_rounds = gang_reservation_rounds
        self.data = data_registry or DataPlane()
        self._lock = threading.Lock()
        # signaled whenever chips return to the free pool, so carve_out
        # waiters wake on release/restore instead of sleep-polling
        self._freed = threading.Condition(self._lock)
        # monotonically bumped on any state mutation; backlog() reuses
        # its cached snapshot while the version is unchanged, and the
        # agent's heartbeat uses it as a dirty flag
        self._version = 0
        self._backlog_cache: Optional[Dict[str, Any]] = None
        self._backlog_version = -1
        # event hook: the agent points this at its wake event so submits
        # and releases wake the scheduling loop instead of a fixed poll
        self.notify: Optional[Any] = None
        self.stats = {"scheduled": 0, "locality_hits": 0, "locality_misses": 0,
                      "app_masters_started": 0, "app_masters_reused": 0,
                      "gang_reservations": 0, "carved_out": 0, "drained": 0,
                      "batch_submits": 0, "micro_charged": 0,
                      "staging_delayed": 0, "staging_expired": 0}

    # ------------------------------------------------------- event plumbing
    def _bump(self) -> None:
        """Mark state dirty (must hold the lock): invalidates the cached
        backlog snapshot the heartbeat reads."""
        self._version += 1

    def _notify(self) -> None:
        """Wake the agent loop (called OUTSIDE the lock)."""
        cb = self.notify
        if cb is not None:
            cb()

    def version(self) -> int:
        """Dirty counter: unchanged between two reads ⇒ no scheduler
        state (queues, bindings, devices) changed between them."""
        with self._lock:
            return self._version

    # ----------------------------------------------------------- lifecycle
    def submit(self, cu: ComputeUnit) -> None:
        """Route the CU to its tenant queue (ACL-checked).  The queue
        keeps its pending list ordered by a stable (-priority, arrival)
        key via ``bisect.insort`` — O(log n), not a full re-sort."""
        with self._lock:
            self.queues.submit(cu)          # PermissionError on ACL violation
            cu._set_state(CUState.PENDING)
            self._bump()
        self._notify()

    def submit_many(self, cus: Sequence[ComputeUnit]) -> None:
        """Batched submit: ONE lock acquisition for the whole batch (the
        overlay/fast-path entry — per-CU locking dominates dispatch at
        10⁴+ tasks).  All-or-nothing on routing errors: every CU's queue
        route is validated (ACLs, declared-queue strictness) before any
        CU is enqueued, so a bad CU mid-batch cannot leave a partial
        batch behind."""
        with self._lock:
            for cu in cus:
                self.queues.route(cu)       # raises before anything queued
            for cu in cus:
                self.queues.submit(cu)
                cu._set_state(CUState.PENDING)
            self.stats["batch_submits"] += 1
            self._bump()
        self._notify()

    def devices_of(self, idxs: Sequence[int]) -> List:
        return [self._devices[i] for i in idxs]

    def pending_cus(self) -> List[ComputeUnit]:
        """Snapshot of queued CUs (PENDING/RESERVED), taken under the lock."""
        with self._lock:
            return [cu for (_, cu), _q in self.queues.pending_entries()
                    if cu.state in (CUState.PENDING, CUState.RESERVED)]

    def evacuate(self) -> List[ComputeUnit]:
        """Failure recovery: atomically pull every pending CU off the
        tenant queues and return the not-yet-done ones.  The pilot is
        dead — nothing will ever bind here again — so the queues empty
        wholesale in ONE lock acquisition; CU states are untouched (the
        ControlPlane replaces each with a clone chain on a survivor).
        Pending CUs hold no queue charges yet: nothing to uncharge."""
        with self._lock:
            out: List[ComputeUnit] = []
            for entry, q in self.queues.pending_entries():
                q.remove(entry)
                cu = entry[1]
                if not cu.done:
                    out.append(cu)
            if out:
                self._bump()
        return out

    def running_assignments(self) -> Dict[str, List[int]]:
        """Snapshot of uid -> bound device indices, taken under the lock."""
        with self._lock:
            return {uid: list(idxs) for uid, idxs in self._running.items()}

    def binding_gen(self, cu: ComputeUnit) -> Optional[int]:
        """Generation token of the CU's current binding; pass it back to
        :meth:`release` so a stale executor can't free a newer binding."""
        with self._lock:
            return self._bound_gen.get(cu.uid)

    # ------------------------------------------------------------ placement
    def _bindable(self, cu: ComputeUnit) -> Set[int]:
        """Chips this CU may bind: the free pool, plus its own gang
        reservation if it holds one."""
        if self._gang_res_uid == cu.uid:
            return self._free | self._gang_res_chips
        return set(self._free)

    def _candidate(self, cu: ComputeUnit) -> Optional[List[int]]:
        """Pick device indices for a CU, honoring slots + locality."""
        need = cu.desc.n_chips
        mem_per = mem_per_chip(cu.desc.memory_bytes, need)
        eligible = [i for i in sorted(self._bindable(cu))
                    if self._mem_free[i] >= mem_per]
        if len(eligible) < need:
            return None
        if not cu.desc.data:
            return eligible[:need]
        # locality scoring: prefer chips already holding the CU's data.
        # The byte-weighted locality measure is additive per device, so
        # ranking eligible devices by the bytes they hold and taking the
        # top `need` yields the best (possibly non-contiguous) placement.
        held = {i: 0.0 for i in eligible}
        for name in cu.desc.data:
            if name not in self.data:
                continue
            pd = self.data.get(name)
            mine = pd.device_set()
            if not mine:
                continue
            per_dev = pd.nbytes / len(mine)
            for i in eligible:
                if self._devices[i] in mine:
                    held[i] += per_dev
        best = sorted(eligible, key=lambda i: (-held[i], i))[:need]
        best_score = self.data.locality_score(
            cu.desc.data, self.devices_of(best))
        if best_score < 1.0:
            # delay scheduling: skip a few rounds hoping a local slot frees
            skips = self._skip_counts.get(cu.uid, 0)
            if skips < self.locality_delay_rounds:
                self._skip_counts[cu.uid] = skips + 1
                return None
            self.stats["locality_misses"] += 1
        else:
            self.stats["locality_hits"] += 1
        self._skip_counts.pop(cu.uid, None)  # scheduled: drop delay state
        return best

    def _admit(self, cu: ComputeUnit,
               queue_name: str = DEFAULT_QUEUE) -> Optional[List[int]]:
        """Two-phase admission; returns bound device indices or None."""
        app = cu.desc.app_id or cu.uid
        # phase 1: AppMaster reservation
        if app not in self._app_masters:
            pool = self._bindable(cu)
            if not pool:
                return None
            am = min(pool)
            self._app_masters[app] = am
            self.stats["app_masters_started"] += 1
            if self.app_master_overhead_s:
                time.sleep(self.app_master_overhead_s)
        elif self.reuse_app_master:
            self.stats["app_masters_reused"] += 1
        cu._set_state(CUState.RESERVED)
        # phase 2: container binding
        cand = self._candidate(cu)
        if cand is None:
            return None
        mem_per = mem_per_chip(cu.desc.memory_bytes, cu.desc.n_chips)
        for i in cand:
            self._free.discard(i)
            self._gang_res_chips.discard(i)
            self._mem_free[i] -= mem_per
        if self._gang_res_uid == cu.uid:
            self._clear_gang_reservation()
        self._running[cu.uid] = cand
        self._bound_gen[cu.uid] = next(self._gen)
        self._gang_waits.pop(cu.uid, None)
        self._staging_waits.pop(cu.uid, None)
        if cu.desc.gang:
            self._running_gangs[cu.uid] = cu.desc.n_chips
        hbm_total = mem_per * cu.desc.n_chips
        self.queues.charge(queue_name, cu.desc.n_chips, hbm_total)
        self._cu_usage[cu.uid] = (queue_name, cu.desc.n_chips, hbm_total)
        self.stats["scheduled"] += 1
        return cand

    def _note_gang_wait(self, cu: ComputeUnit) -> None:
        """A gang CU missed another round; after enough aging, start a
        reservation so freed chips stop leaking to smaller CUs."""
        waits = self._gang_waits.get(cu.uid, 0) + 1
        self._gang_waits[cu.uid] = waits
        if (waits >= self.gang_reservation_rounds
                and self._gang_res_uid is None):
            self._gang_res_uid = cu.uid
            self._gang_res_need = cu.desc.n_chips
            self._gang_res_chips = set()
            self.stats["gang_reservations"] += 1
            # seed the reservation from whatever is free right now
            while (self._free
                   and len(self._gang_res_chips) < self._gang_res_need):
                self._gang_res_chips.add(self._free.pop())

    def _clear_gang_reservation(self) -> None:
        for i in self._gang_res_chips:
            self._free.add(i)
        self._gang_res_chips = set()
        self._gang_res_uid = None
        self._gang_res_need = 0

    def _offer_freed_chip(self, i: int) -> None:
        """A chip became available: feed the gang reservation first.
        Wakes carve_out waiters (must hold the lock)."""
        if (self._gang_res_uid is not None
                and len(self._gang_res_chips) < self._gang_res_need):
            self._gang_res_chips.add(i)
        else:
            self._free.add(i)
        self._freed.notify_all()

    def _capacity(self) -> int:
        """Live bindable slot count (carved chips will return; draining
        and removed ones will not)."""
        return len(self._mem_free) - len(self._draining)

    def try_schedule(self) -> List[Tuple[ComputeUnit, List[int]]]:
        """One scheduling round: returns newly-bound (cu, device idxs)."""
        return [(cu, idxs) for cu, idxs, _gen in self.schedule_round()]

    def schedule_round(self) -> List[Tuple[ComputeUnit, List[int], int]]:
        """One scheduling round: returns newly-bound (cu, device idxs,
        binding generation).  The generation rides along so the agent
        gets it from the same lock acquisition as the bind — the old
        per-CU ``binding_gen`` call re-took the lock once per bound CU.

        The policy re-picks the offering queue after every candidate, so
        usage-driven orders (capacity starvation ratio, DRF dominant
        share) react to binds made earlier in the same round; the fifo
        policy degenerates to the global (-priority, arrival) order."""
        out = []
        dirty = False
        with self._lock:
            # a reservation whose holder left the queue is stale
            if (self._gang_res_uid is not None
                    and not self.queues.has_pending_uid(self._gang_res_uid)):
                self._clear_gang_reservation()
            totals = (max(self._capacity(), 1),
                      max(self._capacity(), 1) * self._hbm)
            snap = {name: list(q.pending)
                    for name, q in self.queues.queues.items() if q.pending}
            cursors = {name: 0 for name in snap}
            while True:
                heads = {name: snap[name][cursors[name]][0]
                         for name in snap if cursors[name] < len(snap[name])}
                if not heads:
                    break
                qname = self.policy.pick_queue(self.queues, heads, totals)
                entry = snap[qname][cursors[qname]]
                cursors[qname] += 1
                _, cu = entry
                q = self.queues.queues[qname]
                if cu.state is CUState.CANCELED:
                    q.remove(entry)
                    dirty = True
                    self._staging_waits.pop(cu.uid, None)
                    if self._gang_res_uid == cu.uid:
                        self._clear_gang_reservation()
                    continue
                if cu.desc.gang and cu.desc.n_chips > self._capacity():
                    cu.error = RuntimeError(
                        f"gang of {cu.desc.n_chips} > pilot size "
                        f"{self._capacity()}")
                    cu._set_state(CUState.FAILED)
                    q.remove(entry)
                    dirty = True
                    self._staging_waits.pop(cu.uid, None)
                    continue
                hbm_req = mem_per_chip(cu.desc.memory_bytes,
                                       cu.desc.n_chips) * cu.desc.n_chips
                cfg = q.config
                if ((cfg.max_chips is not None
                     and cu.desc.n_chips > cfg.max_chips)
                        or (cfg.max_hbm is not None
                            and hbm_req > cfg.max_hbm)):
                    # could never fit even with the queue idle: fail fast
                    # like the gang-too-big case instead of pending forever
                    cu.error = RuntimeError(
                        f"CU wants {cu.desc.n_chips} chips / {hbm_req} HBM "
                        f"> queue {qname!r} max share "
                        f"({cfg.max_chips} chips / {cfg.max_hbm} HBM)")
                    cu._set_state(CUState.FAILED)
                    q.remove(entry)
                    dirty = True
                    self._staging_waits.pop(cu.uid, None)
                    continue
                # staging delay scheduling: a CU whose stage_in is still
                # in flight waits up to staging_delay_rounds for the hot
                # replica to land (prefetch completion wakes the agent
                # immediately), then runs anyway with remote reads — the
                # non-resident bytes get ledgered by the agent's
                # claim_remote fallback, exactly as a synchronous move
                # would have been.  The bound is per-CU and hard: no CU
                # ever waits more than staging_delay_rounds rounds here.
                if not cu.staging_ready():
                    waits = self._staging_waits.get(cu.uid, 0)
                    if waits < self.staging_delay_rounds:
                        self._staging_waits[cu.uid] = waits + 1
                        self.stats["staging_delayed"] += 1
                        continue
                    self.stats["staging_expired"] += 1
                # a CU over its queue's max share stays queued; a capped
                # gang does not age a reservation either — parked chips
                # could never be offered to it anyway
                if not self.policy.may_admit(self.queues, q, cu, hbm_req):
                    continue
                cand = self._admit(cu, qname)
                if cand is None:
                    if cu.desc.gang:
                        self._note_gang_wait(cu)
                else:
                    q.remove(entry)
                    out.append((cu, cand, self._bound_gen[cu.uid]))
            if out or dirty:
                self._bump()
        return out

    # ----------------------------------------------------------- preemption
    def _preempt_gain(self, idxs: Sequence[int]) -> int:
        """Bindable chips actually recovered by evicting a CU: chips on
        DRAINING, carved-out or removed slots never return to the free
        pool, so a CU running there is worthless as a preemption target."""
        blocked = self._draining | self._carved
        return sum(1 for i in idxs
                   if i in self._mem_free and i not in blocked)

    def preemption_victims(self, cu: ComputeUnit,
                           running: Dict[str, ComputeUnit]) -> List[str]:
        """YARN-style preemption: a high-priority pending CU may evict
        enough strictly-lower-priority running CUs to free its slots.
        Returns victim uids (lowest priority first) or [] if impossible.
        The paper notes YARN 'can preempt containers in high-load
        situations' — the agent re-queues victims (bounded by retries).

        Policy-aware: victims on DRAINING devices are never chosen
        (evicting them frees nothing bindable), and under the capacity
        policy a victim is skipped when evicting it would drop its
        queue's chip usage below the queue's guaranteed share — unless
        preemptor and victim share a queue (intra-queue priority
        preemption keeps the queue's usage)."""
        with self._lock:
            need = cu.desc.n_chips - len(self._free)
            my_queue = cu.desc.queue or cu.desc.tenant or DEFAULT_QUEUE
            my_q = self.queues.get(my_queue)
            hbm_req = mem_per_chip(cu.desc.memory_bytes,
                                   cu.desc.n_chips) * cu.desc.n_chips
            # when the preemptor's own queue sits at its max share, only
            # same-queue victims help: evicting other queues frees chips
            # the cap still refuses, which is churn, not progress.  The
            # headroom the victims must free comes on top of `need` —
            # and matters even with chips free (need <= 0), where the
            # only thing blocking the preemptor is its own queue's cap.
            chips_head = hbm_head = 0
            if my_q is not None:
                cfg = my_q.config
                if cfg.max_chips is not None:
                    chips_head = max(my_q.chips_used + cu.desc.n_chips
                                     - cfg.max_chips, 0)
                if cfg.max_hbm is not None:
                    hbm_head = max(my_q.hbm_used + hbm_req - cfg.max_hbm, 0)
            cap_blocked = chips_head > 0 or hbm_head > 0
            if need <= 0 and not cap_blocked:
                return []
            need = max(need, 0)
            usage = {name: q.chips_used
                     for name, q in self.queues.queues.items()}
            candidates = sorted(
                ((v, self._running.get(v.uid, [])) for v in running.values()
                 if v.state is CUState.RUNNING
                 and v.desc.priority < cu.desc.priority
                 and not v.desc.gang),
                key=lambda pair: pair[0].desc.priority)
            victims, freed = [], 0
            for v, idxs in candidates:
                gain = self._preempt_gain(idxs)
                if gain == 0:
                    continue
                vq, vchips, vhbm = self._cu_usage.get(
                    v.uid, (DEFAULT_QUEUE, len(idxs), 0))
                if cap_blocked and vq != my_queue:
                    continue
                floor = self.policy.victim_floor(self.queues, vq)
                if vq != my_queue and usage.get(vq, 0) - vchips < floor:
                    continue
                victims.append(v.uid)
                usage[vq] = usage.get(vq, 0) - vchips
                freed += gain
                if vq == my_queue:
                    chips_head -= vchips
                    hbm_head -= vhbm
                if freed >= need and chips_head <= 0 and hbm_head <= 0:
                    return victims
            return []

    def reclaim_victims(self, running: Dict[str, ComputeUnit]) -> List[str]:
        """Capacity-policy reclaim-via-preemption (YARN's proportional
        capacity preemption): when a guaranteed queue has pending demand
        but sits below its guaranteed chips, evict enough non-gang CUs
        from queues borrowing above *their* guarantees to restore the
        floor.  Victims' queues are never dropped below their own
        guarantees; lowest priority evicts first.  Empty under policies
        that do not reclaim (fifo, drf)."""
        with self._lock:
            if not self.policy.reclaims():
                return []
            deficit, starved = 0, set()
            for q in self.queues.all():
                g = self.queues.guaranteed_chips_of(q)
                if g <= 0:
                    continue
                want = min(g - q.chips_used, q.queued_chip_demand())
                if want > 0:
                    starved.add(q.name)
                    deficit += want
            deficit -= len(self._free)   # free chips satisfy demand first
            if deficit <= 0 or not starved:
                return []
            usage = {name: q.chips_used
                     for name, q in self.queues.queues.items()}
            cands = []
            for v in running.values():
                if v.state is not CUState.RUNNING or v.desc.gang:
                    continue
                info = self._cu_usage.get(v.uid)
                if info is None or info[0] in starved:
                    continue
                gain = self._preempt_gain(self._running.get(v.uid, []))
                if gain:
                    cands.append((v.desc.priority, v.uid, info, gain))
            cands.sort(key=lambda t: (t[0], t[1]))
            victims, freed = [], 0
            for _, uid, (vq, vchips, _vh), gain in cands:
                floor = self.queues.guaranteed_chips_of(self.queues.queues[vq])
                if usage.get(vq, 0) - vchips < floor:
                    continue
                victims.append(uid)
                usage[vq] -= vchips
                freed += gain
                if freed >= deficit:
                    break
            return victims

    def release(self, cu: ComputeUnit, *, gen: Optional[int] = None) -> None:
        """Return a CU's slots. Idempotent: a second release of the same
        binding is a no-op, and a stale ``gen`` token (the binding was
        already released and the CU re-admitted, e.g. the retry or
        speculation paths) never frees the newer binding."""
        with self._lock:
            if gen is not None and self._bound_gen.get(cu.uid) != gen:
                return
            idxs = self._running.pop(cu.uid, None)
            self._bound_gen.pop(cu.uid, None)
            self._running_gangs.pop(cu.uid, None)
            usage = self._cu_usage.pop(cu.uid, None)
            if usage is not None:
                self.queues.uncharge(*usage)
            if not idxs:
                if usage is not None:
                    self._bump()
                return
            self._bump()
            mem_per = mem_per_chip(cu.desc.memory_bytes, cu.desc.n_chips)
            for i in idxs:
                if i not in self._mem_free:
                    continue                      # slot was removed mid-run
                self._mem_free[i] += mem_per
                if i in self._draining or i in self._carved:
                    continue                      # not bindable again
                self._offer_freed_chip(i)
            if not self.reuse_app_master:
                self._app_masters.pop(cu.desc.app_id or cu.uid, None)
        self._notify()

    # ------------------------------------------------------------ carve-out
    def carve_out(self, n: int, timeout: float = 30.0, *,
                  tenant: Optional[str] = None,
                  queue: Optional[str] = None) -> List[int]:
        """Take n free chips (with their full HBM) out of the slot table —
        the Mode-I analytics carve-out. Blocks until n chips are free or
        the timeout expires. Returns the carved indices.

        Carves go through the same queue admission as CUs: the target
        queue's ACL and max share apply, and the carved chips are
        charged to the queue until :meth:`restore` — a tenant cannot
        side-step its caps by carving instead of submitting.

        Waits on a :class:`threading.Condition` signaled whenever chips
        return to the free pool (release/restore/add_devices) — no
        sleep-poll: an idle waiter burns no CPU and wakes promptly."""
        deadline = time.monotonic() + timeout

        def check_caps(q) -> None:
            cfg = q.config
            if (cfg.max_chips is not None
                    and q.chips_used + n > cfg.max_chips):
                raise RuntimeError(
                    f"carve of {n} chips would put queue {q.name!r} "
                    f"over its max share ({q.chips_used} used, "
                    f"max {cfg.max_chips})")
            if (cfg.max_hbm is not None
                    and q.hbm_used + n * self._hbm > cfg.max_hbm):
                raise RuntimeError(
                    f"carve of {n} chips ({n * self._hbm} HBM) would "
                    f"put queue {q.name!r} over its max HBM share "
                    f"({q.hbm_used} used, max {cfg.max_hbm})")

        with self._freed:                         # == self._lock
            q = self.queues.admission_queue(queue, tenant)
            check_caps(q)
            while len(self._free) < n:
                left = deadline - time.monotonic()
                if left <= 0 or not self._freed.wait(timeout=left):
                    raise RuntimeError(
                        f"could not carve out {n} chips (busy)")
                check_caps(q)    # usage may have changed while waiting
            take = sorted(self._free)[:n]
            for i in take:
                self._free.discard(i)
                self._carved.add(i)
                self._carved_charge[i] = (q.name, self._mem_free[i])
                self.queues.charge(q.name, 1, self._mem_free[i])
                self._mem_free[i] = 0   # the chip's HBM goes with it
            self.stats["carved_out"] += n
            self._bump()
            return take

    def restore(self, idxs: Sequence[int]) -> None:
        """Return carved-out chips (and their HBM) to the slot table.
        Idempotent: restoring a chip that is not carved is a no-op."""
        with self._lock:
            for i in idxs:
                if i not in self._carved:
                    continue
                self._carved.discard(i)
                self._mem_free[i] = self._hbm
                qname, hbm = self._carved_charge.pop(i, (DEFAULT_QUEUE, 0))
                self.queues.uncharge(qname, 1, hbm)
                self._offer_freed_chip(i)
                self._bump()
        self._notify()

    # ----------------------------------------------------- micro-task fast path
    # The Raptor overlay (core/raptor.py) bypasses per-CU admission: its
    # workers already hold chips through one long-running gang CU, and
    # micro-tasks only need (a) the submit-time ACL/route check and
    # (b) per-tenant usage charged against the QueueTree so Capacity/DRF
    # caps and fairness still see micro-task load.  These three methods
    # are the whole scheduler surface the overlay touches — each is one
    # lock acquisition for a whole batch/decision.

    def route_micro(self, queue: Optional[str],
                    tenant: Optional[str]) -> str:
        """Validated queue name for a micro-task submitter (ACL-checked,
        strict on declared-queue pilots) — same admission rules as CUs."""
        with self._lock:
            return self.queues.admission_queue(queue, tenant).name

    def acquire_micro(self, heads: Dict[str, Tuple[int, int]],
                      hbms: Optional[Dict[str, int]] = None) -> Optional[str]:
        """One overlay dispatch decision: among the queues with a head
        micro-task (``heads`` maps queue name -> head sort key, ``hbms``
        the head task's HBM bytes), drop those without cap headroom for
        one more chip, let the pilot's scheduling policy pick the winner
        (DRF dominant share and capacity starvation see micro charges
        too), and charge it one chip + the head's HBM.  Returns the
        charged queue name, or None when every candidate queue is at
        its max share."""
        hbms = hbms or {}
        with self._lock:
            eligible = {}
            for name, key in heads.items():
                q = self.queues.get(name)
                if q is None:
                    continue
                cfg = q.config
                if cfg.max_chips is not None \
                        and q.chips_used + 1 > cfg.max_chips:
                    continue
                if cfg.max_hbm is not None \
                        and q.hbm_used + hbms.get(name, 0) > cfg.max_hbm:
                    continue
                eligible[name] = key
            if not eligible:
                return None
            totals = (max(self._capacity(), 1),
                      max(self._capacity(), 1) * self._hbm)
            qname = self.policy.pick_queue(self.queues, eligible, totals)
            self.queues.micro_start(qname, hbms.get(qname, 0))
            self.stats["micro_charged"] += 1
            self._bump()
            return qname

    def micro_uncharge_many(self,
                            charges: Sequence[Tuple[str, int]]) -> None:
        """Batched completion flush: uncharge (queue, hbm) pairs under
        ONE lock acquisition — the overlay's completion buffer drains
        here instead of locking once per finished micro-task."""
        if not charges:
            return
        with self._lock:
            for qname, hbm in charges:
                self.queues.micro_finish(qname, hbm)
            self._bump()

    # -------------------------------------------------------------- drain
    def begin_drain(self, idxs: Sequence[int]) -> List[str]:
        """Mark devices DRAINING: they take no new binds and leave the
        pilot when idle. Returns uids of CUs currently running on them
        (the agent decides whether to wait or preempt)."""
        with self._lock:
            target = {i for i in idxs if i in self._mem_free}
            for i in target:
                self._free.discard(i)
                self._gang_res_chips.discard(i)
                self._draining.add(i)
            if (self._gang_res_uid is not None
                    and self._gang_res_need > self._capacity()):
                self._clear_gang_reservation()  # can never fill now
            self._bump()
            return [uid for uid, assigned in self._running.items()
                    if target & set(assigned)]

    def drain_idle(self, idxs: Sequence[int]) -> bool:
        """True when no running CU still occupies any of `idxs`."""
        with self._lock:
            busy = {i for assigned in self._running.values() for i in assigned}
            return not (set(idxs) & busy)

    def finish_drain(self, idxs: Sequence[int]) -> List:
        """Drop DRAINING slots from the table; returns their device
        objects (for the lease reclaim). Only completes chips that were
        actually marked by :meth:`begin_drain`."""
        with self._lock:
            devs = []
            for i in idxs:
                if i not in self._draining:
                    continue
                self._draining.discard(i)
                self._mem_free.pop(i, None)
                devs.append(self._devices[i])
            self.stats["drained"] += len(devs)
            self._bump()
            return devs

    def max_gang_demand(self) -> int:
        """Largest gang CU currently running or queued.  The ControlPlane
        never drains a pilot below this: an elective rebalance must not
        turn a viable gang into a permanent 'too big for the pilot'
        failure (chips lost to a drain do not come back on their own)."""
        with self._lock:
            demands = [cu.desc.n_chips
                       for (_, cu), _q in self.queues.pending_entries()
                       if cu.desc.gang and not cu.done]
            demands.extend(self._running_gangs.values())
            return max(demands, default=0)

    def guarantee_floor(self) -> int:
        """Chips this pilot must keep to honor demand-backed queue
        guarantees — the ControlPlane never drains below this, so a
        rebalance cannot take chips a guaranteed queue is entitled to."""
        with self._lock:
            return self.queues.guarantee_floor()

    def pick_drain_candidates(self, n: int) -> List[int]:
        """Choose up to n chips to drain: idle chips first, then the
        least-loaded running ones. Carved, reserved and already-draining
        chips are never picked."""
        with self._lock:
            cands = sorted(self._free, reverse=True)[:n]
            if len(cands) < n:
                load: Dict[int, int] = {}
                for assigned in self._running.values():
                    for i in assigned:
                        load[i] = load.get(i, 0) + 1
                busy = sorted(load, key=lambda i: (load[i], -i))
                cands += [i for i in busy if i not in cands][: n - len(cands)]
            return cands[:n]

    # ------------------------------------------------------------- elastic
    def remove_devices(self, idxs: Sequence[int]) -> List[str]:
        """Take devices away (failure/shrink). Returns uids of impacted CUs."""
        impacted = []
        with self._lock:
            for i in idxs:
                self._free.discard(i)
                self._draining.discard(i)
                self._carved.discard(i)
                if i in self._carved_charge:
                    qname, hbm = self._carved_charge.pop(i)
                    self.queues.uncharge(qname, 1, hbm)
                self._gang_res_chips.discard(i)
                self._mem_free.pop(i, None)
            for uid, assigned in list(self._running.items()):
                if set(assigned) & set(idxs):
                    impacted.append(uid)
            self._bump()
        return impacted

    def add_devices(self, devices: Sequence) -> None:
        with self._lock:
            base = len(self._devices)
            self._devices.extend(devices)
            for j in range(len(devices)):
                self._mem_free[base + j] = self._hbm
                self._offer_freed_chip(base + j)
            self._bump()
        self._notify()

    # ---------------------------------------------------------------- stats
    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def n_slots(self) -> int:
        with self._lock:
            return self._capacity()

    def backlog(self) -> Dict[str, Any]:
        """Pressure inputs for the ControlPlane's heartbeat poll, with a
        per-tenant-queue breakdown under ``"queues"`` so the control
        plane can reason about (pilot, queue) pressure and guarantees.

        Cached on the scheduler's version counter: a beat that lands on
        an unchanged scheduler reuses the previous snapshot instead of
        re-walking every queue under the lock (heartbeats at 4 Hz were
        re-merging all pending entries even on an idle pilot).  Callers
        must treat the returned dict as read-only."""
        with self._lock:
            if (self._backlog_cache is not None
                    and self._backlog_version == self._version):
                return self._backlog_cache
            queued = [cu for (_, cu), _q in self.queues.pending_entries()
                      if not cu.done]
            busy = sum(len(v) for v in self._running.values())
            snap = {
                "queue_len": len(queued),
                "queued_chip_demand": sum(c.desc.n_chips for c in queued),
                "n_free": len(self._free),
                "n_slots": self._capacity(),
                "busy_chips": busy,
                "n_running": len(self._running),
                "n_draining": len(self._draining),
                "n_carved": len(self._carved),
                "guarantee_floor": self.queues.guarantee_floor(),
                "queues": self.queues.snapshot(),
            }
            self._backlog_cache = snap
            self._backlog_version = self._version
            return snap
