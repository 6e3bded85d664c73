"""Disaggregated serving: prefill/decode split across pilots.

The port of ``repro.serve.router``: the serving analogue of the paper's
two-cluster layout.  Prefill is the compute-heavy, short-lived stage (a
Hadoop map wave — here Raptor micro-tasks on the compute pilot), decode
is the long-lived, memory-bound stage (≈ a long-running
ApplicationMaster: a gang CU holding a batch of KV caches).  The router sits between them:

  * prompts go to the prefill overlay; completions arrive in finish
    order via ``MicroTask.add_done_callback`` (no head-of-line wait on
    a slow long prompt);
  * each prefilled cache gets a KV-page lease on the DataPlane
    (serve/kv_pages.py), homed where the prefill ran;
  * dispatch picks the decode engine by the placer's score —
    ``locality − movement_cost − load`` over KV residency — so decode
    lands where the cache already lives (the short-circuit read) and
    pays a ledgered DCN splice only when load imbalance is worth it;
  * per-tenant DRF budgets (:class:`DrfAdmission`, one shared QueueTree
    across all engines) cap a flooding tenant's total slot + KV-byte
    footprint fleet-wide, not just per engine.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dataplane import GFS_ARCHIVE, Link, TransferCostModel
from repro_torch.core.queues import DrfPolicy, QueueTree
from repro_torch.serve.engine import (AdmissionControl, PrefillResult,
                                      Request, ServeEngine)
from repro_torch.serve.kv_pages import KVPageManager


class DrfAdmission(AdmissionControl):
    """Dominant-Resource-Fairness admission over (decode slots, KV bytes).

    One instance is shared by every decode engine in a pool: charges go
    to a single QueueTree, so budgets bind fleet-wide.  ``plan`` orders
    the waiting line by weighted dominant share (smallest first — the
    starved tenant goes next) and skips tenants at their ``max_chips``
    slot cap or ``max_hbm`` KV-byte cap."""

    def __init__(self, tree: QueueTree, *, slots_total: int,
                 kv_bytes_total: int):
        self.tree = tree
        self.totals = (max(slots_total, 1), max(kv_bytes_total, 1))
        self._lock = threading.Lock()
        self.peak_slots: Dict[str, int] = {}   # test/bench observability

    def _queue(self, tenant: str):
        return self.tree.admission_queue(tenant, tenant)

    def admissible_ever(self, req: Request) -> bool:
        q = self._queue(req.tenant)
        return q.config.max_chips != 0

    def plan(self, waiting: List[Request], n_free: int,
             engine: ServeEngine) -> List[Request]:
        with self._lock:
            order = sorted(
                range(len(waiting)),
                key=lambda i: (DrfPolicy.dominant_share(
                    self._queue(waiting[i].tenant), self.totals), i))
            chosen: List[Request] = []
            for i in order:
                if len(chosen) >= n_free:
                    break
                req = waiting[i]
                q = self._queue(req.tenant)
                cap = q.config.max_chips
                if cap is not None and q.chips_used + 1 > cap:
                    continue
                hbm_cap = q.config.max_hbm
                if hbm_cap is not None and q.hbm_used + req.kv_bytes > hbm_cap:
                    continue
                self.tree.charge(req.tenant, 1, req.kv_bytes)
                self.peak_slots[req.tenant] = max(
                    self.peak_slots.get(req.tenant, 0), q.chips_used)
                chosen.append(req)
            return chosen

    def release(self, req: Request, engine: ServeEngine) -> None:
        with self._lock:
            self.tree.uncharge(req.tenant, 1, req.kv_bytes)


class EngineHandle:
    """One decode engine pinned to a pilot, running as a long-lived
    loop (the gang-CU body) on its own thread."""

    def __init__(self, engine: ServeEngine, pilot: str):
        self.engine = engine
        self.pilot = pilot
        self.stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self.engine.run_forever, args=(self.stop_event,),
            name=f"decode-{self.engine.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def load(self) -> float:
        e = self.engine
        return (e.n_active + e.backlog) / max(e.slots, 1)


class ServeRouter:
    """Routes requests: prefill overlay → KV lease → locality-scored
    decode engine.

    ``prefill_fn(tokens, bucket) -> PrefillResult`` runs on the overlay
    when one is given (micro-tasks on the compute pilot), else inline
    on the dispatcher threads.  ``kv`` pages are allocated on
    ``prefill_pilot`` and spliced (ledgered) when dispatch picks an
    engine elsewhere."""

    def __init__(self, handles: Sequence[EngineHandle], kv: KVPageManager,
                 cost_model: Optional[TransferCostModel] = None, *,
                 prefill_fn: Callable[[Any, int], PrefillResult],
                 prefill_pilot: str, bucket: int = 32, overlay=None,
                 locality_weight: float = 1.0, load_weight: float = 0.5,
                 n_dispatchers: int = 2,
                 free_policy: str = "free"):
        assert handles, "need at least one decode engine"
        assert free_policy in ("free", "spool")
        self.handles = list(handles)
        self.kv = kv
        self.cost_model = cost_model or TransferCostModel()
        self.prefill_fn = prefill_fn
        self.prefill_pilot = prefill_pilot
        self.bucket = bucket
        self.overlay = overlay
        self.locality_weight = locality_weight
        self.load_weight = load_weight
        self.free_policy = free_policy
        self._ready: "queue.Queue[Optional[Tuple[Request, Any]]]" \
            = queue.Queue()
        self._lock = threading.Lock()
        self.submitted = 0
        self.finished = 0
        self.rejected = 0
        self._all_done = threading.Event()
        self._all_done.set()
        self.stats = {"dispatched": 0, "cross_pilot": 0, "splice_bytes": 0,
                      "prefill_offloaded": 0, "recovered_requests": 0}
        for h in self.handles:
            h.engine.on_finish = self._on_finish
            h.start()
        self._dispatchers = [
            threading.Thread(target=self._dispatch_loop,
                             name=f"serve-dispatch-{i}", daemon=True)
            for i in range(max(1, n_dispatchers))]
        for t in self._dispatchers:
            t.start()

    # --------------------------------------------------------------- intake
    def _bucket_for(self, plen: int) -> int:
        return max(self.bucket,
                   ((plen + self.bucket - 1) // self.bucket) * self.bucket)

    def submit(self, req: Request) -> None:
        admission = self.handles[0].engine.admission
        if not admission.admissible_ever(req):
            with self._lock:
                self.rejected += 1
            raise PermissionError(
                f"tenant {req.tenant!r} has a zero serve budget")
        if not req.t_submit:
            req.t_submit = time.monotonic()
        with self._lock:
            self.submitted += 1
            self._all_done.clear()
        if self.overlay is not None:
            kv_est = self.kv.bytes_for_tokens(len(req.tokens) + req.max_new)
            task = self.overlay.submit(
                self.prefill_fn, req.tokens, self._bucket_for(len(req.tokens)),
                tenant=req.tenant, queue=req.tenant, tag="prefill",
                hbm_bytes=kv_est)
            with self._lock:
                self.stats["prefill_offloaded"] += 1
            # completion-ordered handoff: a slow long prompt does not
            # block dispatch of the short ones behind it
            task.add_done_callback(lambda t, r=req: self._ready.put((r, t)))
        else:
            self._ready.put((req, None))

    # ------------------------------------------------------------- dispatch
    def _pick_engine(self, req: Request) -> Tuple[EngineHandle, float]:
        """affinity + locality − movement_cost, over KV residency."""
        best, best_score = None, None
        for h in self.handles:
            loc = self.kv.locality(req.uid, h.pilot)
            move = self.cost_model.movement_cost(
                self.kv.bytes_nonresident(req.uid, h.pilot), Link.DCN)
            score = (self.locality_weight * loc - move
                     - self.load_weight * h.load())
            if best_score is None or score > best_score:
                best, best_score = h, score
        return best, best_score

    def _dispatch_loop(self) -> None:
        while True:
            item = self._ready.get()
            if item is None:
                return
            req, task = item
            try:
                if task is None:
                    pre = self.prefill_fn(
                        req.tokens, self._bucket_for(len(req.tokens)))
                else:
                    pre = task.wait(timeout=0)   # done by construction
                lease = self.kv.alloc(req.uid,
                                      len(req.tokens) + req.max_new,
                                      self.prefill_pilot)
                req.kv_bytes = lease.nbytes
                handle, _ = self._pick_engine(req)
                wire = self.kv.splice_to(req.uid, handle.pilot)
                with self._lock:
                    self.stats["dispatched"] += 1
                    if wire:
                        self.stats["cross_pilot"] += 1
                        self.stats["splice_bytes"] += wire
                handle.engine.submit_prefilled(req, pre)
            except Exception as exc:       # pragma: no cover - defensive
                req.done = True
                req.t_done = time.monotonic()
                req.output = None
                req.error = exc            # type: ignore[attr-defined]
                self._count_finished()

    # ------------------------------------------------------------- recovery
    def recover_pilot(self, pilot_uid: str) -> int:
        """A decode pilot died: retire its engines and re-dispatch every
        unfinished request onto the survivors.  KV pages spooled to
        ``@gfs`` (free_policy='spool' deployments) are restored from the
        archive onto the new engine's pilot; pages that lived only on
        the dead pilot are gone — those requests get a fresh lease and
        re-prefill.  Called from the ControlPlane's ``on_pilot_dead``
        hook BEFORE the DataPlane drops the dead pilot's replicas, so
        the archive flags are still visible.  Returns requests moved."""
        with self._lock:
            dead = [h for h in self.handles if h.pilot == pilot_uid]
            if not dead:
                return 0
            survivors = [h for h in self.handles if h.pilot != pilot_uid]
            if not survivors:
                raise RuntimeError(
                    f"serve router: last decode pilot {pilot_uid} died — "
                    f"no survivor to take its requests")
            self.handles = survivors
        recovered = 0
        for h in dead:
            h.stop()
            for req, pre in h.engine.evacuate():
                target, _ = self._pick_engine(req)
                lease = self.kv.lease(req.uid)
                archived = (lease is not None and lease.pages and GFS_ARCHIVE
                            in self.kv.data.home_pilots(lease.pages[0]))
                if archived:
                    # the cache survived in the archive: page it back in
                    self.kv.restore(req.uid, target.pilot)
                else:
                    if lease is not None:
                        self.kv.free(req.uid)
                    lease = self.kv.alloc(req.uid,
                                          len(req.tokens) + req.max_new,
                                          self.prefill_pilot)
                    req.kv_bytes = lease.nbytes
                    self.kv.splice_to(req.uid, target.pilot)
                if pre is None:
                    # decode state died with the pilot: prefill again
                    pre = self.prefill_fn(
                        req.tokens, self._bucket_for(len(req.tokens)))
                target.engine.submit_prefilled(req, pre)
                recovered += 1
        with self._lock:
            self.stats["recovered_requests"] += recovered
        return recovered

    # ------------------------------------------------------------- lifetime
    def _on_finish(self, req: Request) -> None:
        if self.free_policy == "spool" and self.kv.lease(req.uid):
            self.kv.spool(req.uid)
        else:
            self.kv.free(req.uid)
        self._count_finished()

    def _count_finished(self) -> None:
        with self._lock:
            self.finished += 1
            if self.finished >= self.submitted:
                self._all_done.set()

    def drain(self, timeout_s: float = 300.0) -> None:
        """Block until every submitted request has finished."""
        if not self._all_done.wait(timeout=timeout_s):
            snaps = [h.engine.snapshot() for h in self.handles]
            raise TimeoutError(
                f"serve router: {self.finished}/{self.submitted} done "
                f"after {timeout_s:.0f}s; engines: {snaps}")

    @property
    def backlog(self) -> int:
        return (self._ready.qsize()
                + sum(h.engine.backlog for h in self.handles))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {"submitted": self.submitted, "finished": self.finished,
                   "rejected": self.rejected, "backlog": self.backlog,
                   **self.stats}
        out["engines"] = [h.engine.snapshot() for h in self.handles]
        out["kv"] = self.kv.snapshot()
        return out

    def stop(self) -> None:
        for _ in self._dispatchers:
            self._ready.put(None)
        for t in self._dispatchers:
            t.join(timeout=10.0)
        for h in self.handles:
            h.stop()
