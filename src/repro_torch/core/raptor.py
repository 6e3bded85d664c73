"""Raptor-style micro-task overlay: million-task dispatch inside a pilot.

The paper's Fig-5 analysis shows per-CU overhead (YARN's two-phase
AppMaster -> container allocation) dominating short tasks, and lists
container/AppMaster re-use as the fix.  Our pilots have the same
problem: every ComputeUnit pays scheduler admission, gang/queue
arbitration and an agent wake per task, which caps dispatch far below
"millions of users".  RADICAL-Pilot solves it with the Raptor
master/worker overlay (arXiv:1501.05041 measures the same
pilot-overhead-vs-task-granularity trade-off): ONE long-running CU
amortizes admission over any number of function-call-sized tasks.

Architecture (mirrors Hadoop's uber-AM / Tez container re-use):

  * :class:`RaptorMaster` is itself scheduled as one long-running
    **gang CU** on the pilot — the chips it holds are admitted, HBM-
    accounted and queue-charged exactly once, like a long-running
    AppMaster;
  * it owns N persistent **worker executors** (one thread per gang
    chip, plus optional 1-chip extension CUs from :meth:`grow`) that
    pull pickled-function :class:`MicroTask`\\ s from a shared bounded
    in-pilot queue — no per-task scheduler admission at all;
  * completions land in **batched buffers**: a worker publishes
    results and releases its queue charges once per batch (one
    scheduler-lock acquisition per flush, not per task);
  * **per-tenant accounting folds back into the QueueTree**: each
    dispatched micro-task charges one chip (+ its HBM) to the
    submitting tenant's queue for exactly the time it runs, so
    Capacity/DRF caps and dominant-share fairness hold over micro-task
    load, and the pilot's own scheduling policy arbitrates between
    tenants' head tasks (``scheduler.acquire_micro``);
  * per-tag **EMA runtimes and backlog** ride the agent heartbeat
    (``status["overlays"]``) so the ControlPlane can grow/shrink an
    overlay under pressure (:meth:`grow`/:meth:`shrink` submit/retire
    1-chip non-gang worker-extension CUs through normal admission);
  * a worker that **dies mid-task** is reaped by the master's monitor:
    its in-flight task is uncharged and re-queued at the FRONT of its
    tenant queue, its completed-but-unflushed batch is published, and
    a replacement worker starts.

Functions are ``pickle``-serialized at submit and deserialized on the
worker (the wire format a distributed agent would ship); closures that
cannot pickle fall back to passing the callable by reference — same
process, so execution is identical.
"""
from __future__ import annotations

import itertools
import pickle
import threading
import time
from collections import deque
from concurrent.futures import thread as _cf_thread
from typing import (Any, Callable, Deque, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

from .compute_unit import ComputeUnitDescription

_master_counter = itertools.count()

EMA_ALPHA = 0.3


class MicroTask:
    """One function-call-sized unit of overlay work.

    Not a ComputeUnit: it never visits the scheduler's admission path.
    ``wait()`` blocks until a worker has executed it AND its completion
    batch was flushed (results publish batch-at-a-time)."""

    __slots__ = ("uid", "seq", "queue", "tenant", "tag", "priority",
                 "hbm_bytes", "result", "error", "timings",
                 "_payload", "_raw", "_done", "_callbacks", "_cb_lock")

    def __init__(self, seq: int, fn: Callable, args: Tuple, kwargs: Dict,
                 *, queue: str, tenant: Optional[str], tag: str,
                 priority: int = 0, hbm_bytes: int = 0):
        self.uid = f"mt-{seq:08d}"
        self.seq = seq
        self.queue = queue
        self.tenant = tenant
        self.tag = tag
        self.priority = priority
        self.hbm_bytes = hbm_bytes
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.timings: Dict[str, float] = {"t_submit": time.monotonic()}
        try:
            self._payload: Optional[bytes] = pickle.dumps((fn, args, kwargs))
            self._raw: Optional[Tuple] = None
        except Exception:  # closures/lambdas: same-process reference
            self._payload = None
            self._raw = (fn, args, kwargs)
        self._done = threading.Event()
        self._callbacks: List[Callable[["MicroTask"], None]] = []
        self._cb_lock = threading.Lock()

    @property
    def sort_key(self) -> Tuple[int, int]:
        """Same stable (-priority, arrival) key the QueueTree uses."""
        return (-self.priority, self.seq)

    def _load(self) -> Tuple[Callable, Tuple, Dict]:
        if self._payload is not None:
            return pickle.loads(self._payload)
        return self._raw  # type: ignore[return-value]

    def _finish(self) -> None:
        with self._cb_lock:
            self._done.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                pass  # a bad callback must not take down the flusher

    def add_done_callback(self, cb: Callable[["MicroTask"], None]) -> None:
        """Run `cb(task)` when the result publishes (completion order,
        on the master's flush thread — keep it cheap, e.g. a queue
        push).  Fires immediately if already done."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"{self.uid} not done after {timeout}s")
        if self.error is not None:
            raise RuntimeError(f"{self.uid} failed: {self.error}") \
                from self.error
        return self.result

    def dispatch_s(self) -> Optional[float]:
        """Submit -> execution-start latency (the Fig-5 overhead for a
        micro-task — compare ComputeUnit.overhead_s())."""
        t1 = self.timings.get("t_start")
        return None if t1 is None else t1 - self.timings["t_submit"]


class RaptorMaster:
    """Master of one in-pilot micro-task overlay (see module docstring).

    Lifecycle: construct -> :meth:`start` (submits the gang CU; blocks
    until workers are live) -> ``submit``/``submit_many``/``map`` ->
    :meth:`shutdown` (drains by default).  Usually built via
    ``pilot.spawn_raptor(...)`` or implicitly by ``Session.map``.
    """

    def __init__(self, pilot, n_workers: int, *,
                 queue: Optional[str] = None, tenant: Optional[str] = None,
                 maxsize: int = 4096, batch_size: int = 32,
                 name: Optional[str] = None):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.pilot = pilot
        self.agent = pilot.agent
        self._sched = pilot.agent.scheduler
        self.n_workers = n_workers
        self.queue = queue                 # host queue the gang CU binds in
        self.tenant = tenant
        self.maxsize = maxsize
        self.batch_size = max(batch_size, 1)
        self.name = name or f"raptor-{next(_master_counter):03d}"
        self.uid = self.name
        # -- shared in-pilot task queue (bounded; per-tenant-queue deques
        #    so the scheduling policy can arbitrate between heads)
        self._pending: Dict[str, Deque[MicroTask]] = {}
        self._npending = 0
        self._cv = threading.Condition()   # guards pending/inflight/threads
        self._seq = itertools.count()
        # -- worker state
        self._threads: Dict[int, threading.Thread] = {}
        self._batches: Dict[int, List[MicroTask]] = {}
        self._inflight: Dict[int, MicroTask] = {}
        self._stopped: set = set()         # clean worker exits
        self._retired: set = set()         # reaped (died) worker ids
        self._dead_wids: set = set()       # announced deaths (extension
        #   workers run on pool threads that outlive them, so thread
        #   aliveness alone cannot signal a worker's death)
        self._ext_wids: set = set()        # extension-CU workers
        self._shrink_wids: set = set()     # extensions told to retire
        self._fail_wids: set = set()       # test hook: die on next task
        self._wid = itertools.count()
        # -- lifecycle flags
        self._closed = False               # no new submits
        self._halt = False                 # workers exit even with backlog
        self._ready = threading.Event()
        self._cu = None                    # the master's own gang CU
        self._ext_cus: List = []
        # -- stats (own lock: flushes must not contend with dispatch)
        self._stats_lock = threading.Lock()
        self._ema: Dict[str, float] = {}   # tag -> task-runtime EMA
        self.stats = {"submitted": 0, "completed": 0, "failed": 0,
                      "flushes": 0, "worker_deaths": 0, "requeued": 0,
                      "grown": 0, "shrunk": 0}
        self._t_start = time.monotonic()

    # ------------------------------------------------------------ lifecycle
    def start(self, timeout: float = 30.0) -> "RaptorMaster":
        """Submit the master as ONE long-running gang CU (n_workers
        chips admitted/charged once) and wait until its workers pull."""
        assert self.agent is not None, "pilot not started"
        self._cu = self.pilot.submit(ComputeUnitDescription(
            fn=self._master_main, gang=True, n_chips=self.n_workers,
            needs_mesh=False, tag=f"raptor:{self.name}",
            app_id=f"raptor:{self.name}",
            tenant=self.tenant, queue=self.queue))
        self.agent.register_overlay(self)
        deadline = time.monotonic() + timeout
        while not self._ready.wait(timeout=0.02):
            if self._cu.done:              # gang too big / admission failed
                self.agent.unregister_overlay(self)
                raise RuntimeError(
                    f"raptor master CU failed to start: {self._cu.error}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"raptor master not live after {timeout}s")
        return self

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> Dict:
        """Stop the overlay.  ``drain=True`` (default) refuses new
        submits, lets workers finish every pending micro-task, then
        retires them; ``drain=False`` cancels pending tasks (their
        ``wait`` raises) and stops after in-flight tasks.  Returns the
        master's final stats.  Idempotent."""
        with self._cv:
            self._closed = True
            if not drain:
                self._halt = True
                for dq in self._pending.values():
                    for t in dq:
                        t.error = RuntimeError(
                            "overlay shut down before task ran")
                        t._finish()
                    dq.clear()
                self._npending = 0
            self._cv.notify_all()
        if self._cu is not None:
            self._cu.wait(timeout)
        for cu in self._ext_cus:
            if not cu.done:
                cu.wait(timeout)
        self.agent.unregister_overlay(self)
        return dict(self.stats)

    # -------------------------------------------------------------- submit
    @staticmethod
    def _insert(dq: Deque[MicroTask], task: MicroTask) -> None:
        """Keep a tenant queue ordered by (-priority, seq).  Uniform
        priority (the overwhelmingly common case) is an O(1) append;
        a requeued in-flight task (oldest seq) is an O(1) appendleft."""
        if not dq or task.sort_key >= dq[-1].sort_key:
            dq.append(task)
        elif task.sort_key <= dq[0].sort_key:
            dq.appendleft(task)
        else:
            idx = len(dq)
            while idx > 0 and dq[idx - 1].sort_key > task.sort_key:
                idx -= 1
            dq.insert(idx, task)

    def submit(self, fn: Callable, *args, tenant: Optional[str] = None,
               queue: Optional[str] = None, tag: str = "micro",
               priority: int = 0, hbm_bytes: int = 0, **kwargs) -> MicroTask:
        return self.submit_many([(fn, args, kwargs)], tenant=tenant,
                                queue=queue, tag=tag, priority=priority,
                                hbm_bytes=hbm_bytes)[0]

    def submit_many(self, calls: Iterable, *, tenant: Optional[str] = None,
                    queue: Optional[str] = None, tag: str = "micro",
                    priority: int = 0, hbm_bytes: int = 0,
                    ) -> List[MicroTask]:
        """Batched submit: ONE route/ACL check and one condition
        acquisition per batch.  ``calls`` items are callables or
        ``(fn, args)`` / ``(fn, args, kwargs)`` tuples.  Blocks for
        backpressure while the bounded in-pilot queue is full."""
        # admission-rule check once per batch (ACL, declared-queue
        # strictness) — the same rules a CU submit would hit
        qname = self._sched.route_micro(queue, tenant)
        tasks: List[MicroTask] = []
        for call in calls:
            if callable(call):
                fn, args, kwargs = call, (), {}
            elif len(call) == 2:
                fn, args = call
                kwargs = {}
            else:
                fn, args, kwargs = call
            tasks.append(MicroTask(next(self._seq), fn, args, kwargs,
                                   queue=qname, tenant=tenant, tag=tag,
                                   priority=priority, hbm_bytes=hbm_bytes))
        i = 0
        with self._cv:
            dq = self._pending.setdefault(qname, deque())
            while i < len(tasks):
                if self._closed:
                    raise RuntimeError(f"overlay {self.name} is shut down")
                space = self.maxsize - self._npending
                if space <= 0:             # backpressure: bounded queue
                    self._cv.wait(timeout=1.0)
                    continue
                chunk = tasks[i:i + space]
                for task in chunk:
                    self._insert(dq, task)
                self._npending += len(chunk)
                i += len(chunk)
                self._cv.notify_all()
        with self._stats_lock:
            self.stats["submitted"] += len(tasks)
        return tasks

    def map(self, fn: Callable, items: Sequence, *,
            tenant: Optional[str] = None, queue: Optional[str] = None,
            tag: str = "map") -> List[MicroTask]:
        """One micro-task per item (``fn(item)``), order-stable."""
        return self.submit_many([(fn, (it,)) for it in items],
                                tenant=tenant, queue=queue, tag=tag)

    def _halted(self) -> bool:
        # the master CU runs on an agent pool thread; if the interpreter
        # exits without a shutdown(), concurrent.futures' atexit hook
        # would join that thread forever — treat it as a halt signal
        return self._halt or _cf_thread._shutdown

    # ----------------------------------------------------------- the master
    def _master_main(self) -> Dict:
        """Body of the master's gang CU: boot workers, monitor/reap,
        exit when the overlay is retired.  Long-running by design."""
        with self._cv:
            for _ in range(self.n_workers):
                self._start_worker_locked()
        self._ready.set()
        try:
            with self._cv:
                while True:
                    self._reap_dead_locked()
                    live = any(self._is_live_locked(w) for w in self._threads)
                    if self._halted() and not live:
                        break
                    if self._closed and not live and self._npending == 0:
                        break
                    self._cv.wait(timeout=0.05)
        finally:
            self._ready.set()
        return dict(self.stats)

    def _start_worker_locked(self, wid: Optional[int] = None) -> int:
        wid = next(self._wid) if wid is None else wid
        th = threading.Thread(target=self._worker_loop, args=(wid,),
                              daemon=True,
                              name=f"{self.name}-worker-{wid}")
        self._threads[wid] = th
        self._batches.setdefault(wid, [])
        th.start()
        return wid

    def _is_live_locked(self, wid: int) -> bool:
        th = self._threads.get(wid)
        return (th is not None and th.is_alive()
                and wid not in self._stopped
                and wid not in self._retired
                and wid not in self._dead_wids)

    def _reap_dead_locked(self) -> None:
        """Worker-death recovery: requeue the in-flight micro-task at
        the front of its queue (charge released), publish the dead
        worker's completed-but-unflushed batch, start a replacement."""
        for wid, th in list(self._threads.items()):
            if wid in self._stopped or wid in self._retired:
                continue
            if th.is_alive() and wid not in self._dead_wids:
                continue
            self._retired.add(wid)
            self.stats["worker_deaths"] += 1
            task = self._inflight.pop(wid, None)
            if task is not None and not task.done:
                # the dispatch charge is held until flush — release it,
                # then put the task back at the FRONT of its queue
                self._sched.micro_uncharge_many(
                    [(task.queue, task.hbm_bytes)])
                self._insert(self._pending.setdefault(task.queue, deque()),
                             task)
                self._npending += 1
                self.stats["requeued"] += 1
            self._flush_locked(self._batches.get(wid, []))
            if not (self._halt or self._closed) \
                    and wid not in self._ext_wids:
                self._start_worker_locked()
            self._cv.notify_all()

    # ----------------------------------------------------------- the workers
    def _worker_loop(self, wid: int) -> None:
        batch = self._batches.setdefault(wid, [])
        while True:
            task = self._next_task(wid, batch)
            if task is None:
                break
            if wid in self._fail_wids:     # failure injection (tests /
                self._fail_wids.discard(wid)  # chaos): die task-in-hand
                with self._cv:
                    self._dead_wids.add(wid)
                    self._cv.notify_all()
                return
            self._run_task(task)
            with self._cv:
                self._inflight.pop(wid, None)
                batch.append(task)
                if len(batch) >= self.batch_size:
                    self._flush_locked(batch)
                self._cv.notify_all()
        with self._cv:
            self._flush_locked(batch)
            self._stopped.add(wid)
            self._cv.notify_all()

    def _next_task(self, wid: int,
                   batch: List[MicroTask]) -> Optional[MicroTask]:
        """Pull the next runnable micro-task: the pilot's scheduling
        policy arbitrates between queue heads and the winner's queue is
        charged (one scheduler-lock acquisition).  Flushes the worker's
        completion batch before blocking — parked completions must not
        hold queue charges (or unpublished results) across a wait."""
        with self._cv:
            while True:
                if self._halted() or (self._closed and self._npending == 0) \
                        or wid in self._shrink_wids:
                    self._shrink_wids.discard(wid)
                    return None
                heads, hbms = {}, {}
                for qn, dq in self._pending.items():
                    if dq:
                        heads[qn] = dq[0].sort_key
                        hbms[qn] = dq[0].hbm_bytes
                blocked = False
                if heads:
                    qname = self._sched.acquire_micro(heads, hbms)
                    if qname is not None:
                        task = self._pending[qname].popleft()
                        self._npending -= 1
                        self._inflight[wid] = task
                        self._cv.notify_all()   # space for submitters
                        return task
                    blocked = True     # every head queue is at its cap
                self._flush_locked(batch)
                # cap-blocked: timed wait (headroom frees via scheduler
                # releases, which do not signal this condition); empty:
                # submits/shutdown notify promptly, timeout is a net
                self._cv.wait(timeout=0.02 if blocked else 0.5)

    def _run_task(self, task: MicroTask) -> None:
        task.timings["t_start"] = time.monotonic()
        try:
            fn, args, kwargs = task._load()
            task.result = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — worker must survive
            task.error = e
        task.timings["t_done"] = time.monotonic()

    def _flush_locked(self, batch: List[MicroTask]) -> None:
        """Drain one completion buffer: release the batch's queue
        charges in ONE scheduler-lock acquisition, fold runtimes into
        per-tag EMAs, then publish results (events set last, so a woken
        waiter observes the charges already released)."""
        if not batch:
            return
        tasks, batch[:] = list(batch), []
        self._sched.micro_uncharge_many(
            [(t.queue, t.hbm_bytes) for t in tasks])
        with self._stats_lock:
            for t in tasks:
                rt = t.timings["t_done"] - t.timings["t_start"]
                ema = self._ema.get(t.tag)
                self._ema[t.tag] = (rt if ema is None
                                    else (1 - EMA_ALPHA) * ema
                                    + EMA_ALPHA * rt)
                if t.error is not None:
                    self.stats["failed"] += 1
            self.stats["completed"] += len(tasks)
            self.stats["flushes"] += 1
        for t in tasks:
            t._finish()

    # ------------------------------------------------------------ elasticity
    def grow(self, n: int = 1) -> List:
        """Add n workers as 1-chip NON-gang extension CUs — they ride
        normal scheduler admission (charged to the overlay's host
        queue), so growth competes fairly with regular CU load and
        simply stays queued when the pilot is full."""
        cus = []
        for _ in range(n):
            wid = next(self._wid)
            self._ext_wids.add(wid)
            cu = self.pilot.submit(ComputeUnitDescription(
                fn=self._extension_main, args=(wid,), n_chips=1,
                needs_mesh=False, tag=f"raptor:{self.name}:ext",
                app_id=f"raptor:{self.name}",
                tenant=self.tenant, queue=self.queue))
            cus.append(cu)
            self._ext_cus.append(cu)
        with self._stats_lock:
            self.stats["grown"] += n
        return cus

    def _extension_main(self, wid: int) -> int:
        """Body of one extension CU: run a worker loop on the extra
        chip until shrunk or the overlay retires."""
        with self._cv:
            self._threads[wid] = threading.current_thread()
            self._batches.setdefault(wid, [])
        try:
            self._worker_loop(wid)
        finally:
            with self._cv:
                if wid not in self._stopped:   # crashed mid-loop: the pool
                    self._dead_wids.add(wid)   # thread survives, announce
                self._cv.notify_all()          # the death for the reaper
        return wid

    def shrink(self, n: int = 1) -> int:
        """Retire up to n extension workers (base gang workers never
        shrink — the master CU's chips stay bound until shutdown).
        Each retiree finishes its current task, flushes, and its CU
        completes, returning the chip to the scheduler."""
        with self._cv:
            live_ext = [w for w in self._ext_wids
                        if self._is_live_locked(w)
                        and w not in self._shrink_wids]
            victims = live_ext[:n]
            self._shrink_wids.update(victims)
            self._cv.notify_all()
        with self._stats_lock:
            self.stats["shrunk"] += len(victims)
        return len(victims)

    def orphans(self) -> List[MicroTask]:
        """Failure recovery: the overlay's pilot is dead.  Halt the
        master (idempotent) and hand back every micro-task that never
        published — pending plus in-flight — so the ControlPlane can
        resubmit them on a surviving overlay.  Pending tasks were never
        charged and the dead scheduler's in-flight charges die with it,
        so no uncharge happens here.  A worker thread that outlives the
        crash may still publish its task-in-hand locally (a partitioned
        worker finishing its last task); ``MicroTask._finish`` fires
        callbacks exactly once, so the resubmitted duplicate's mirror
        is then a benign no-op — at-least-once execution, exactly-once
        result publication."""
        out: List[MicroTask] = []
        with self._cv:
            self._closed = True
            self._halt = True
            for dq in self._pending.values():
                out.extend(t for t in dq if not t.done)
                dq.clear()
            self._npending = 0
            out.extend(t for t in self._inflight.values() if not t.done)
            self._inflight.clear()
            self._cv.notify_all()
        return out

    # ------------------------------------------------------- failure inject
    def fail_worker(self, wid: int) -> None:
        """Failure injection (tests/chaos): the worker dies 'holding'
        its next micro-task — exercising the reap/requeue path."""
        self._fail_wids.add(wid)

    def worker_ids(self) -> List[int]:
        with self._cv:
            return [w for w in self._threads if self._is_live_locked(w)]

    # ----------------------------------------------------------- telemetry
    def snapshot(self) -> Dict[str, Any]:
        """Backlog/pressure view exported through the agent heartbeat
        (``status["overlays"]``) — what the ControlPlane's
        ``scale_overlays`` reads to grow/shrink this overlay."""
        with self._cv:
            per_queue = {qn: len(dq)
                         for qn, dq in self._pending.items() if dq}
            pending = self._npending
            inflight = len(self._inflight)
            workers = sum(1 for w in self._threads if self._is_live_locked(w))
        with self._stats_lock:
            completed = self.stats["completed"]
            ema = dict(self._ema)
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        return {
            "name": self.name,
            "pending": pending,
            "per_queue": per_queue,
            "inflight": inflight,
            "workers": workers,
            "completed": completed,
            "worker_deaths": self.stats["worker_deaths"],
            "ema_task_s": ema,
            "throughput_tps": completed / elapsed,
            "backlog_per_worker": pending / max(workers, 1),
        }

    @property
    def alive(self) -> bool:
        return (self._cu is not None and not self._cu.done
                and not self._closed)
