"""RADICAL-Pilot-Agent analogue: LRM + Scheduler + TaskSpawner + LaunchMethod.

The agent runs a scheduling loop on its own thread (the paper's agent
pulls CUs from MongoDB; ours pulls from a thread-safe queue), binds CUs
to device slots through the YARN-style scheduler, and executes them via
a small TaskSpawner pool. Includes:
  * executor cache — the 'container re-use' optimization the paper lists
    as future work (compiled callables keyed by (app_id, fn));
  * straggler mitigation — per-tag EMA runtimes; a watchdog launches a
    speculative duplicate when a CU overruns; first finisher wins;
  * failure handling — device loss re-queues impacted CUs (bounded by
    max_retries) on the shrunken slot table;
  * heartbeats — a periodically refreshed backlog/pressure snapshot
    (queue depth, chip demand, EMA runtimes) the ControlPlane polls to
    decide cross-pilot rebalances;
  * drain servicing — :meth:`service_drain` stops new binds on a device
    set, waits for (or preempts and re-queues) the CUs on it, and hands
    the freed devices back for the lease reclaim.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

from .compute_unit import ComputeUnit, ComputeUnitDescription, CUState
from .scheduler import YarnStyleScheduler

SPECULATION_FACTOR = 3.0   # launch duplicate past 3x the tag's EMA runtime
SPECULATION_MIN_S = 0.5


def platform_of(device) -> str:
    """The reference's platform word for a device: ``torch.device`` has
    no ``.platform``, so its ``type`` is mapped (``cuda`` -> ``gpu``)."""
    kind = device.type
    return "gpu" if kind == "cuda" else kind


class LocalResourceManager:
    """Introspects the pilot's allocation (paper: LRM reads env vars)."""

    def __init__(self, pilot):
        self.devices = list(pilot.devices)
        self.n_chips = len(self.devices)
        self.hbm_per_chip = pilot.rm.hbm_per_chip

    def info(self) -> Dict[str, Any]:
        return {"n_chips": self.n_chips, "hbm_per_chip": self.hbm_per_chip,
                "platform": (platform_of(self.devices[0]) if self.devices
                             else "none")}


class Agent:
    def __init__(self, pilot, *, reuse_app_master: bool = True,
                 app_master_overhead_s: float = 0.0,
                 n_spawners: Optional[int] = None,
                 enable_speculation: bool = True):
        self.pilot = pilot
        self.lrm = LocalResourceManager(pilot)
        self.scheduler = YarnStyleScheduler(
            self.lrm.devices, self.lrm.hbm_per_chip, pilot.data,
            reuse_app_master=reuse_app_master,
            app_master_overhead_s=app_master_overhead_s,
            staging_delay_rounds=getattr(pilot.desc,
                                         "staging_delay_rounds", 8),
            policy=getattr(pilot.desc, "scheduler_policy", "fifo"),
            queues=getattr(pilot.desc, "queues", None))
        # sized past the slot count so an elastic grow (absorbed devices)
        # still finds idle spawner threads; executors are sleep-heavy in
        # the dry-run, so over-provisioning is cheap
        workers = n_spawners or max(4, 2 * self.lrm.n_chips + 4)
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix=f"{pilot.uid}-spawn")
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # passive liveness: stamped ONLY by the agent's own loop, never
        # by a forced heartbeat() — so a ControlPlane poll cannot make a
        # wedged/killed agent look alive (the detection substrate of
        # check_failures' heartbeat deadline)
        self.last_alive = time.monotonic()
        self._killed = False               # chaos: agent process crashed
        self._cus: Dict[str, ComputeUnit] = {}
        self._ema: Dict[str, float] = {}         # tag -> runtime EMA
        # roofline estimate-vs-actual cross-check: the Session reports
        # each placed stage's (est_s, actual_s) pair here; the EMA of
        # the actual/est ratio and the last sample ride the heartbeat
        # so the ControlPlane can observe cost-model drift per pilot
        self._est_n = 0
        self._est_ema_ratio: Optional[float] = None
        self._est_last: Dict[str, Any] = {}
        self._executor_cache: Dict[Any, Any] = {}
        self.enable_speculation = enable_speculation
        self.status: Dict[str, Any] = {}
        self._status_version = -1     # scheduler version the status reflects
        self._overlays: Dict[str, Any] = {}   # Raptor masters on this pilot
        self._serves: Dict[str, Any] = {}     # decode engines on this pilot
        self._lock = threading.Lock()
        # event-driven wake: the scheduler signals submits/releases/grows
        # directly instead of the loop discovering them on a fixed poll
        self.scheduler.notify = self._wake.set

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"{self.pilot.uid}-agent")
        self._thread.start()

    def stop(self) -> None:
        for m in self.overlays():   # halt straggler overlays (no drain)
            try:
                m.shutdown(drain=False, timeout=2.0)
            except Exception:       # noqa: BLE001 — stop must not raise
                pass
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._pool.shutdown(wait=False, cancel_futures=True)
        # let go of the work this agent ran: a finished CU's function may
        # close over its caller (a Session stage's job holds the Session,
        # whose pilots hold this agent), and such a cycle would keep the
        # function's data (a trainer's state on the card) until ``gc``
        with self._lock:
            self._executor_cache.clear()
            self._cus = {uid: cu for uid, cu in self._cus.items()
                         if not cu.done}

    def kill(self) -> None:
        """Chaos: the agent process crashes.  Unlike :meth:`stop` there
        is no drain and no goodbye — the scheduling loop and heartbeats
        stop abruptly, queued spawns are dropped, and results of CUs
        still executing are never published (:meth:`_spawn` suppresses
        publication for a killed agent).  Detection is the
        ControlPlane's job: ``last_alive`` freezes at the crash and the
        heartbeat deadline eventually declares the pilot DEAD."""
        self._killed = True
        self._stop.set()
        self._wake.set()
        self._pool.shutdown(wait=False, cancel_futures=True)

    # -------------------------------------------------------------- submit
    def submit(self, desc: ComputeUnitDescription, *,
               staging: Optional[Sequence] = None) -> ComputeUnit:
        cu = ComputeUnit(desc)
        # stage-in futures must attach BEFORE the CU becomes visible to
        # a scheduling round, or delay scheduling never sees them.
        # ``staging`` carries requests the Session already issued at
        # placement-decision time; otherwise desc.stage_in is enqueued
        # here (the direct pilot.submit path).
        prefetcher = getattr(self.pilot, "prefetcher", None)
        if staging is not None:
            cu.staging_futures = list(staging)
        elif desc.stage_in and prefetcher is not None:
            cu.staging_futures = prefetcher.request_many(
                desc.stage_in, priority=desc.priority,
                reason=f"stage-in:{cu.uid}")
        # queue routing can reject (ACL violation, unknown queue on a
        # declared-queue pilot) — register only after it succeeds so a
        # rejected submit does not leave a zombie CU in the table
        self.scheduler.submit(cu)
        with self._lock:
            self._cus[cu.uid] = cu
        self._wake.set()
        return cu

    def submit_many(self, descs: Sequence[ComputeUnitDescription]
                    ) -> List[ComputeUnit]:
        """Batched submit: routing is validated for the whole batch and
        the queue is extended under ONE scheduler-lock acquisition
        (``scheduler.submit_many``), with a single agent wake at the
        end.  All-or-nothing: a routing rejection admits no CU."""
        cus = [ComputeUnit(d) for d in descs]
        prefetcher = getattr(self.pilot, "prefetcher", None)
        if prefetcher is not None:
            for cu in cus:
                if cu.desc.stage_in:
                    cu.staging_futures = prefetcher.request_many(
                        cu.desc.stage_in, priority=cu.desc.priority,
                        reason=f"stage-in:{cu.uid}")
        self.scheduler.submit_many(cus)
        with self._lock:
            for cu in cus:
                self._cus[cu.uid] = cu
        self._wake.set()
        return cus

    # ------------------------------------------------------------- overlays
    def register_overlay(self, master) -> None:
        with self._lock:
            self._overlays[master.uid] = master

    def unregister_overlay(self, master) -> None:
        with self._lock:
            self._overlays.pop(master.uid, None)

    def overlays(self) -> List:
        with self._lock:
            return list(self._overlays.values())

    # ----------------------------------------------------- serving engines
    def register_serve(self, engine) -> None:
        """Track a decode engine living on this pilot so its backlog
        rides the heartbeat (ControlPlane pressure sees serving load)."""
        with self._lock:
            self._serves[engine.name] = engine

    def unregister_serve(self, engine) -> None:
        with self._lock:
            self._serves.pop(engine.name, None)

    def serves(self) -> List:
        with self._lock:
            return list(self._serves.values())

    # ------------------------------------------------- roofline cross-check
    def record_estimate(self, tag: str, est_s: float,
                        actual_s: float) -> None:
        """Fold one roofline estimate-vs-actual sample (a placed stage
        that ran here) into the pilot's drift stats.  The per-tag EMA
        runtime (:meth:`_record_runtime`) tracks the same actuals from
        the CU side; this pairs them with the *predicted* time."""
        ratio = actual_s / max(est_s, 1e-12)
        with self._lock:
            self._est_n += 1
            self._est_ema_ratio = (ratio if self._est_ema_ratio is None
                                   else 0.7 * self._est_ema_ratio
                                   + 0.3 * ratio)
            self._est_last = {"tag": tag, "est_s": est_s,
                              "actual_s": actual_s, "ratio": ratio}
        self._status_version = -1     # next heartbeat must re-snapshot

    def estimate_calibration(self) -> Optional[float]:
        """EMA actual/estimate ratio (None before the first sample) —
        an opt-in multiplier for the Session's est_runtime term."""
        with self._lock:
            return self._est_ema_ratio

    def reserve_chips(self, n: int, *, tenant: Optional[str] = None,
                      queue: Optional[str] = None) -> List[int]:
        """Take n chips out of the slot table (Mode-I analytics carve-out).
        Goes through the scheduler's public carve-out API, which also
        moves the chips' HBM out of the admission accounting and charges
        the chips to the (ACL-checked) tenant queue."""
        return self.scheduler.carve_out(n, timeout=30.0,
                                        tenant=tenant, queue=queue)

    def return_chips(self, idxs: Sequence[int]) -> None:
        self.scheduler.restore(idxs)
        self._wake.set()

    # ---------------------------------------------------------------- loop
    def _loop(self) -> None:
        while not self._stop.is_set():
            self.last_alive = time.monotonic()
            self._check_preemption()
            # schedule_round binds and reads the binding generation in
            # ONE lock acquisition (try_schedule + per-CU binding_gen
            # used to take the lock again for every bound CU)
            for cu, idxs, gen in self.scheduler.schedule_round():
                cu.assigned_devices = self.scheduler.devices_of(idxs)
                self._pool.submit(self._spawn, cu, gen)
            self._check_stragglers()
            self._heartbeat()
            # event-driven wake: submits/releases/restores signal _wake
            # via scheduler.notify, so the timeout is only a safety net.
            # Poll fast solely while the straggler watchdog has running
            # CUs to time; an idle (or speculation-off) agent sleeps.
            backlog = self.scheduler.backlog()
            watching = self.enable_speculation and backlog["busy_chips"] > 0
            self._wake.wait(timeout=0.02 if watching else 0.25)
            self._wake.clear()

    # ------------------------------------------------------------ heartbeat
    def _heartbeat(self, force: bool = False) -> None:
        """Paper Fig 3: the agent's Heartbeat Monitor — a periodically
        refreshed liveness/status snapshot the Pilot-Manager's
        ControlPlane polls for backlog pressure."""
        if self._killed:
            return          # a crashed agent beats no more, even forced
        now = time.monotonic()
        if not force and now - getattr(self, "_last_beat", 0.0) < 0.25:
            return
        self._last_beat = now
        # dirty-flag fast path: when the scheduler version hasn't moved
        # since the last beat, nothing the snapshot reports has changed —
        # skip re-walking CU states and queues entirely (the ControlPlane
        # keeps polling idle pilots; beats must not cost lock traffic).
        version = self.scheduler.version()
        overlays = self.overlays()
        serves = self.serves()
        prefetcher = getattr(self.pilot, "prefetcher", None)
        staging_active = prefetcher is not None and prefetcher.active
        if (not force and self.status and not overlays and not serves
                and not staging_active
                and version == self._status_version):
            self.status["t"] = now
            return
        self._status_version = version
        with self._lock:
            states: Dict[str, int] = {}
            for cu in self._cus.values():
                states[cu.state.value] = states.get(cu.state.value, 0) + 1
            ema = dict(self._ema)
            roofline = {"n": self._est_n,
                        "ema_error_ratio": self._est_ema_ratio,
                        "last": dict(self._est_last)}
        backlog = self.scheduler.backlog()
        self.status = {
            "t": now,
            "free_chips": backlog["n_free"],
            "n_slots": backlog["n_slots"],
            "busy_chips": backlog["busy_chips"],
            "queue_len": backlog["queue_len"],
            "queued_chip_demand": backlog["queued_chip_demand"],
            "n_draining": backlog["n_draining"],
            "guarantee_floor": backlog["guarantee_floor"],
            "queue_backlog": backlog["queues"],
            "ema_runtimes": ema,
            # estimate-vs-actual drift of the roofline placement model
            # on this pilot (Session.record via record_estimate)
            "roofline": roofline,
            "cu_states": states,
            "scheduler": dict(self.scheduler.stats),
            # overlay pressure (pending depth, EMA micro-task runtimes,
            # backlog-per-worker) for ControlPlane.scale_overlays
            "overlays": {m.uid: m.snapshot() for m in overlays},
            # staging backlog + LRU cache stats — the ControlPlane folds
            # the backlog into pressure_of so a pilot drowning in
            # transfers is not also handed more work
            "staging": (prefetcher.snapshot()
                        if prefetcher is not None else {}),
            # decode-engine occupancy + waiting lines — the ControlPlane
            # folds the serve backlog into pressure_of so a pilot whose
            # engines are drowning in requests stops attracting more work
            "serve": {e.name: e.snapshot() for e in serves},
        }

    def heartbeat(self) -> Dict[str, Any]:
        """Force-refresh and return the status snapshot (ControlPlane poll)."""
        self._heartbeat(force=True)
        return self.status

    def _check_preemption(self) -> None:
        """Evict lower-priority running CUs for starved high-priority ones
        (victims are canceled and re-queued), then let a starved
        guaranteed queue reclaim chips from over-guarantee borrowers
        (capacity policy only — the scheduler picks the victims)."""
        pending = self.scheduler.pending_cus()
        if not pending:
            return
        with self._lock:
            running = dict(self._cus)
        top = max(pending, key=lambda c: c.desc.priority)
        if top.desc.priority > 0:
            self._evict_all(self.scheduler.preemption_victims(top, running),
                            "preempted")
        self._evict_all(self.scheduler.reclaim_victims(running),
                        "capacity_reclaimed")

    def _evict_all(self, uids: Sequence[str], stat_key: str) -> None:
        for uid in uids:
            victim = self._cus.get(uid)
            if victim is None or victim.done:
                continue
            self._requeue_clone(victim)
            self.scheduler.stats[stat_key] = \
                self.scheduler.stats.get(stat_key, 0) + 1

    def _requeue_clone(self, victim: ComputeUnit, *,
                       retries: Optional[int] = None) -> ComputeUnit:
        """Cancel a CU and replace it with a fresh clone on the queue.
        The forwarding pointer (victim.result = clone) is published
        BEFORE the CANCELED state wakes any waiter, so CU.follow never
        observes a canceled CU with no clone to chase."""
        clone = ComputeUnit(victim.desc)
        clone.retries = victim.retries if retries is None else retries
        with self._lock:
            self._cus[clone.uid] = clone
        victim.result = clone
        victim._set_state(CUState.CANCELED)
        self.scheduler.release(victim)
        self.scheduler.submit(clone)
        self._wake.set()
        return clone

    # --------------------------------------------------------------- drain
    def service_drain(self, idxs: Sequence[int], *,
                      preempt_after_s: float = 0.5,
                      timeout: float = 30.0) -> List:
        """Service a ControlPlane drain request: stop new binds on `idxs`,
        wait for the CUs running there to finish — preempting (cancel +
        re-queue onto surviving slots) any still running after
        ``preempt_after_s`` — then drop the slots.  Returns the freed
        device objects for the lease reclaim."""
        self.scheduler.begin_drain(idxs)
        t0 = time.monotonic()
        preempted = False
        while not self.scheduler.drain_idle(idxs):
            now = time.monotonic()
            if not preempted and now - t0 >= preempt_after_s:
                self._preempt_draining(idxs)
                preempted = True
            if now - t0 > timeout:
                break          # logical slots: finish anyway, CUs complete
            time.sleep(0.005)
        devs = self.scheduler.finish_drain(idxs)
        self._wake.set()
        return devs

    def _preempt_draining(self, idxs: Sequence[int]) -> None:
        target = set(idxs)
        for uid, assigned in self.scheduler.running_assignments().items():
            if not target & set(assigned):
                continue
            victim = self._cus.get(uid)
            if victim is None or victim.done:
                continue
            self._requeue_clone(victim)
            self.scheduler.stats["drain_preempted"] = \
                self.scheduler.stats.get("drain_preempted", 0) + 1

    # --------------------------------------------------------- TaskSpawner
    def _spawn(self, cu: ComputeUnit, gen: Optional[int] = None) -> None:
        if self._killed:                 # crashed agent: spawn nothing
            return
        if cu.done:                      # canceled while queued in the pool
            self.scheduler.release(cu, gen=gen)
            self._wake.set()
            return
        # delay budget expired with transfers still in flight: convert any
        # unclaimed stage-in to a remote read (exactly one side wins the
        # PENDING->REMOTE vs PENDING->IN_FLIGHT race; a transfer already
        # claimed by a worker just finishes and the bytes stay promoted)
        prefetcher = getattr(self.pilot, "prefetcher", None)
        if prefetcher is not None:
            for req in cu.staging_futures:
                prefetcher.claim_remote(req)
        cu._set_state(CUState.RUNNING)
        try:
            kwargs = dict(cu.desc.kwargs)
            if cu.desc.needs_mesh:
                kwargs["mesh"] = self.pilot.mesh(cu.assigned_devices)
            fn = self._launch_method(cu)
            result = fn(*cu.desc.args, **kwargs)
            # a speculation winner or a preemption may have resolved this
            # CU while fn ran — never clobber the published result; a
            # killed agent publishes nothing (its CUs were re-queued on
            # survivors by the recovery — a late local completion must
            # not race the clone that replaced it)
            if self._killed or cu.done or cu.state is CUState.CANCELED:
                return
            cu.result = result
            cu._set_state(CUState.DONE)
            self._record_runtime(cu)
            self._resolve_speculation(cu)
            # stage-out rides the same pipeline, off the critical path:
            # the CU is DONE before the spool to GFS even starts
            if prefetcher is not None and cu.desc.stage_out:
                prefetcher.request_many(
                    cu.desc.stage_out, kind="out",
                    priority=cu.desc.priority,
                    reason=f"stage-out:{cu.uid}")
        except BaseException as e:  # noqa: BLE001 — agent must survive any CU
            if self._killed or cu.done or cu.state is CUState.CANCELED:
                return
            cu.error = e
            if cu.retries < cu.desc.max_retries:
                cu.retries += 1
                cu._done.clear()
                self.scheduler.release(cu, gen=gen)
                self.scheduler.submit(cu)
                self._wake.set()
                return
            cu._set_state(CUState.FAILED)
        finally:
            # gen guards the retry race: if this CU was already released
            # and re-admitted, the stale token makes this a no-op
            self.scheduler.release(cu, gen=gen)
            self._wake.set()

    def _launch_method(self, cu: ComputeUnit):
        """Paper: LaunchMethod encapsulates mpiexec/aprun/yarn specifics.
        Here: executor caching = AppMaster/container re-use."""
        key = (cu.desc.app_id, cu.desc.fn)
        if cu.desc.app_id is not None and key in self._executor_cache:
            return self._executor_cache[key]
        fn = cu.desc.fn
        if cu.desc.app_id is not None:
            self._executor_cache[key] = fn
        return fn

    # ---------------------------------------------------------- stragglers
    def _record_runtime(self, cu: ComputeUnit) -> None:
        rt = cu.runtime_s()
        if rt is None:
            return
        ema = self._ema.get(cu.desc.tag)
        self._ema[cu.desc.tag] = rt if ema is None else 0.7 * ema + 0.3 * rt

    def _expected_runtime(self, cu: ComputeUnit) -> Optional[float]:
        """The straggler watchdog's baseline for one CU: the tag's EMA
        when history exists, else the placer's roofline estimate
        (``desc.est_runtime_s``) calibrated by this pilot's observed
        EMA actual/estimate ratio (the roofline est-drift sample) — so a
        first-of-its-tag stage is speculated against the model's
        prediction instead of never."""
        ema = self._ema.get(cu.desc.tag)
        if ema is not None:
            return ema
        est = cu.desc.est_runtime_s
        if est is None:
            return None
        with self._lock:
            ratio = self._est_ema_ratio
        return est * ratio if ratio else est

    def _check_stragglers(self) -> None:
        if not self.enable_speculation:
            return
        now = time.monotonic()
        with self._lock:
            running = [c for c in self._cus.values()
                       if c.state is CUState.RUNNING and c.speculative_of is None]
        for cu in running:
            expected = self._expected_runtime(cu)
            if expected is None:
                continue
            started = cu.timings.get("t_running")
            if started is None:
                continue
            elapsed = now - started
            already = any(c.speculative_of == cu.uid for c in self._cus.values())
            if (elapsed > max(SPECULATION_FACTOR * expected, SPECULATION_MIN_S)
                    and not already and self.scheduler.n_free >= cu.desc.n_chips):
                dup = ComputeUnit(cu.desc)
                dup.speculative_of = cu.uid
                with self._lock:
                    self._cus[dup.uid] = dup
                self.scheduler.submit(dup)

    def _resolve_speculation(self, done_cu: ComputeUnit) -> None:
        """First finisher wins: the winner's result is mirrored into the
        still-running counterpart, which is CANCELED — it did not
        produce the value, and its late return must neither clobber the
        published result (the ``cu.done`` guard in ``_spawn``) nor leak
        its queue charge (the executor's finally-release uncharges)."""
        with self._lock:
            pairs = [c for c in self._cus.values()
                     if c.uid != done_cu.uid and (
                         c.speculative_of == done_cu.uid
                         or done_cu.speculative_of == c.uid)]
        for other in pairs:
            if not other.done:
                other.result = done_cu.result
                other._set_state(CUState.CANCELED)

    # ------------------------------------------------------------- failure
    def handle_device_loss(self, devices: Sequence) -> List[str]:
        # count-aware slot matching: dry-run slices alias one physical
        # device across many slots, so each lost device claims exactly
        # ONE matching slot (losing a chip must not wipe the pilot)
        idxs: List[int] = []
        for d in devices:
            i = next((i for i, dev in enumerate(self.scheduler._devices)
                      if id(dev) == id(d) and i not in idxs), None)
            if i is not None:
                idxs.append(i)
        impacted = self.scheduler.remove_devices(idxs)
        for uid in impacted:
            cu = self._cus.get(uid)
            if cu is None or cu.done:
                continue
            if cu.retries < max(cu.desc.max_retries, 1):
                self._requeue_clone(cu, retries=cu.retries + 1)
            else:
                # terminal: retry budget exhausted — FAILED with a
                # diagnostic, never a silent CANCELED (waiters must see
                # the failure, not a None result)
                cu.error = RuntimeError(
                    f"{cu.uid} (tag {cu.desc.tag!r}) lost its devices on "
                    f"{self.pilot.uid} and exhausted its retry budget "
                    f"({cu.retries}/{max(cu.desc.max_retries, 1)} retries)")
                cu._set_state(CUState.FAILED)
        self._wake.set()
        return impacted
