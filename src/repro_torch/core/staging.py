"""Tiered data staging: the DataPlane's active side.

Until now every inter-pilot transfer was synchronous and on the
critical path: a stage placed on a pilot without its inputs paid the
DCN move *before* its compute could start.  The paper's Hadoop side is
exactly about not doing that — overlapping data movement with compute
is the architectural lever Hadoop gets right ("A Tale of Two
Data-Intensive Paradigms", arXiv:1403.1528), and Pilot-Data staging
directives are the unifying primitive (arXiv:1501.05041).  RADICAL-
Pilot exposes it as per-task ``stage_in``/``stage_out`` specs; so do
we:

  * :class:`DataRef` — a declarative staging directive: dataset name,
    optional link hint (``ici``/``dcn``/``gfs``) and optional wire
    compression (``compress="int8"`` rides
    :mod:`repro_torch.optim.compression` for DCN/GFS transfers above a size
    threshold, ledgered at compressed size);
  * :class:`StageRequest` — one queued transfer with a future-like
    interface (``wait``/``done``) and an atomic state machine
    (PENDING → IN_FLIGHT → DONE, or PENDING → REMOTE when the consumer
    gave up waiting and read remotely instead);
  * :class:`ReplicaCache` — per-pilot LRU over the replicas the
    prefetcher landed, bounded by a byte budget.  A cache hit skips
    the transfer entirely (the short-circuit local read); eviction is
    lineage-safe — the last replica of a dataset is never dropped;
  * :class:`Prefetcher` — owned by each Pilot, fed by the Session
    placer at placement-decision time.  Bounded worker threads pull
    requests from a priority queue and execute GFS→DCN→ICI tier
    promotion via :meth:`DataPlane.replicate_to` *while predecessor
    stages are still running*.  The scheduler holds a CU whose
    ``stage_in`` is in flight for up to ``staging_delay_rounds``
    (delay scheduling), then lets it run with remote reads — bytes
    ledgered as before via :meth:`Prefetcher.claim_remote`.

Backlog and cache pressure are exported through agent heartbeats
(``status["staging"]``) so the ControlPlane folds staging backlog into
its per-pilot pressure signal.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import queue
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Union

from .dataplane import DataPlane, Link, replicated_sharding


@dataclasses.dataclass(frozen=True)
class DataRef:
    """Declarative staging directive: one dataset a CU reads
    (``stage_in``) or publishes (``stage_out``).

    ``link_hint`` names the tier the transfer should ride (defaults:
    DCN for stage-in promotion, GFS for stage-out spool); ``compress``
    selects wire compression (currently ``"int8"``) for DCN/GFS
    transfers above the prefetcher's size threshold.  A stage-out with
    ``evict_after`` drops the spooling pilot's replica once the archive
    copy lands — true cold tiering (a finished request's KV pages leave
    HBM accounting but stay restorable from ``@gfs``)."""
    name: str
    link_hint: Optional[str] = None
    compress: Optional[str] = None
    evict_after: bool = False

    def link(self, default: str) -> str:
        return self.link_hint or default


def as_refs(refs: Sequence[Union["DataRef", str]]) -> List["DataRef"]:
    """Normalize a mixed name/DataRef sequence (``stage_in=["pts"]``
    and ``stage_in=[DataRef("pts", compress="int8")]`` both work)."""
    return [r if isinstance(r, DataRef) else DataRef(str(r)) for r in refs]


class StageState(enum.Enum):
    PENDING = "pending"        # queued, no worker picked it up yet
    IN_FLIGHT = "in_flight"    # a worker is moving the bytes
    DONE = "done"              # replica landed (or cache hit)
    REMOTE = "remote"          # consumer ran with remote reads instead
    FAILED = "failed"


_req_counter = itertools.count()


class StageRequest:
    """One queued staging operation, with a future-like interface.

    ``kind="in"`` promotes a replica onto the target pilot;
    ``kind="out"`` spools a produced dataset out (GFS archive by
    default).  State transitions are atomic: exactly one of the
    prefetcher worker (→ IN_FLIGHT) and the consumer's remote-read
    fallback (→ REMOTE) wins a PENDING request."""

    def __init__(self, ref: DataRef, *, kind: str = "in", priority: int = 0,
                 reason: str = ""):
        self.uid = f"stage-{next(_req_counter):06d}"
        self.ref = ref
        self.kind = kind
        self.priority = priority
        self.reason = reason
        self.state = StageState.PENDING
        self.wire_bytes = 0        # bytes that actually crossed the link
        self.hit = False           # satisfied by a resident replica
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self._lock = threading.Lock()

    def try_transition(self, src: StageState, dst: StageState) -> bool:
        with self._lock:
            if self.state is not src:
                return False
            self.state = dst
            return True

    def _resolve(self, state: StageState, wire_bytes: int = 0,
                 error: Optional[BaseException] = None) -> None:
        with self._lock:
            self.state = state
            self.wire_bytes = wire_bytes
            self.error = error
        self._event.set()

    @property
    def done(self) -> bool:
        """True once the consumer need not wait any longer (landed,
        failed, or converted to a remote read)."""
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> int:
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.uid} ({self.ref.name}) not staged "
                               f"after {timeout}s")
        if self.state is StageState.FAILED:
            raise RuntimeError(
                f"staging {self.ref.name} failed: {self.error}"
            ) from self.error
        return self.wire_bytes


class ReplicaCache:
    """Per-pilot LRU over prefetched replicas, bounded by a byte budget.

    The cache does not hold arrays — the DataPlane does; it tracks
    *which* datasets this pilot keeps a replica of and in what recency
    order.  Admitting past the budget evicts least-recently-used
    entries by dropping this pilot from the dataset's home set
    (:meth:`DataPlane.drop_replica`) — a later read pays the transfer
    again.  Eviction is lineage-safe: a replica that is the dataset's
    LAST is never dropped, even over budget (counted under
    ``unevictable``)."""

    def __init__(self, pilot_uid: str, dataplane: DataPlane,
                 budget_bytes: Optional[int] = None):
        self.pilot_uid = pilot_uid
        self.data = dataplane
        self.budget_bytes = budget_bytes
        self._entries: "OrderedDict[str, int]" = OrderedDict()  # name->bytes
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "evicted_bytes": 0, "unevictable": 0}

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    @property
    def bytes_cached(self) -> int:
        with self._lock:
            return sum(self._entries.values())

    def touch(self, name: str) -> None:
        """Mark a replica recently used (cache-hit path)."""
        with self._lock:
            if name in self._entries:
                self._entries.move_to_end(name)

    def admit(self, name: str, nbytes: int) -> List[str]:
        """Track a landed replica; evict LRU entries past the budget.
        Returns the names evicted (their replica on this pilot was
        dropped from the DataPlane home set)."""
        with self._lock:
            self._entries[name] = nbytes
            self._entries.move_to_end(name)
            if self.budget_bytes is None:
                return []
            evicted = []
            # walk LRU -> MRU; the just-admitted entry is last and is
            # only reached when nothing older could be evicted
            for cand in list(self._entries):
                if sum(self._entries.values()) <= self.budget_bytes:
                    break
                if cand == name:
                    break        # never evict what we just admitted
                if not self.data.drop_replica(cand, self.pilot_uid,
                                              keep_last=True):
                    self.stats["unevictable"] += 1
                    continue     # last replica (or already gone): skip
                nb = self._entries.pop(cand)
                self.stats["evictions"] += 1
                self.stats["evicted_bytes"] += nb
                evicted.append(cand)
            return evicted

    def forget(self, name: str) -> None:
        """Drop tracking without touching the DataPlane (the replica
        left through another path, e.g. a drain eviction)."""
        with self._lock:
            self._entries.pop(name, None)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes_cached": sum(self._entries.values()),
                    "budget_bytes": self.budget_bytes,
                    **self.stats}


class Prefetcher:
    """Per-pilot async staging pipeline: bounded worker threads pull
    :class:`StageRequest`s from a priority queue and execute tier
    promotion through the shared DataPlane while predecessor stages
    are still running.

    Workers start lazily on the first request (most pilots never
    stage), and every resolution calls ``notify`` (wired to the
    agent's wake event) so a delay-scheduled CU binds on the next
    scheduler round instead of a poll later."""

    DEFAULT_MIN_COMPRESS_BYTES = 1 << 16   # compress only above 64 KiB

    def __init__(self, pilot, dataplane: DataPlane, *, n_workers: int = 2,
                 cache_bytes: Optional[int] = None,
                 min_compress_bytes: int = DEFAULT_MIN_COMPRESS_BYTES):
        self.pilot = pilot
        self.data = dataplane
        self.n_workers = max(1, n_workers)
        self.min_compress_bytes = min_compress_bytes
        self.cache = ReplicaCache(pilot.uid, dataplane, cache_bytes)
        self.notify: Optional[Any] = None     # agent wake hook
        self._q: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = itertools.count()
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # per-dataset transfer locks: duplicate requests for one name
        # (two CUs reading the same input) coalesce — the second waits
        # for the first's replica to land, then resolves as a hit
        self._name_locks: Dict[str, threading.Lock] = {}
        self._in_flight = 0
        self.stats = {"requests": 0, "transfers": 0, "bytes_moved": 0,
                      "remote_reads": 0, "remote_bytes": 0,
                      "stage_outs": 0, "failed": 0}

    # ------------------------------------------------------------- requests
    def request(self, ref: Union[DataRef, str], *, kind: str = "in",
                priority: int = 0, reason: str = "") -> StageRequest:
        """Enqueue one staging operation; returns its future."""
        (ref,) = as_refs([ref])
        req = StageRequest(ref, kind=kind, priority=priority, reason=reason)
        with self._lock:
            self.stats["requests"] += 1
            self._ensure_workers()
        self._q.put((-priority, next(self._seq), req))
        return req

    def request_many(self, refs: Sequence[Union[DataRef, str]], *,
                     kind: str = "in", priority: int = 0,
                     reason: str = "") -> List[StageRequest]:
        return [self.request(r, kind=kind, priority=priority, reason=reason)
                for r in as_refs(refs)]

    def claim_remote(self, req: StageRequest) -> bool:
        """The consumer's delay budget expired: convert a still-PENDING
        request into a remote read — the non-resident bytes are
        ledgered on the request's link exactly as the old synchronous
        path did, and the future resolves so nothing waits on it.  An
        IN_FLIGHT or DONE request is left alone (the replica is landing
        anyway and will serve the next reader)."""
        if not req.try_transition(StageState.PENDING, StageState.REMOTE):
            return False
        nbytes = 0
        if req.ref.name in self.data:
            nbytes = self.data.bytes_nonresident(
                [req.ref.name], self.pilot.uid, self.pilot.devices)
            if nbytes:
                self.data.record_moved(
                    nbytes, req.ref.link(Link.DCN),
                    reason=f"remote-read:{req.ref.name}")
        with self._lock:
            self.stats["remote_reads"] += 1
            self.stats["remote_bytes"] += nbytes
        req._resolve(StageState.REMOTE, nbytes)
        self._notify()
        return True

    # -------------------------------------------------------------- workers
    def _ensure_workers(self) -> None:
        """Start worker threads on first use (must hold the lock)."""
        while len(self._workers) < self.n_workers:
            t = threading.Thread(
                target=self._worker, daemon=True,
                name=f"{self.pilot.uid}-stage-{len(self._workers)}")
            self._workers.append(t)
            t.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                _, _, req = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if not req.try_transition(StageState.PENDING,
                                      StageState.IN_FLIGHT):
                continue      # claimed as a remote read while queued
            with self._lock:
                self._in_flight += 1
            try:
                self._execute(req)
            except BaseException as e:  # noqa: BLE001 — worker must survive
                with self._lock:
                    self.stats["failed"] += 1
                req._resolve(StageState.FAILED, error=e)
            finally:
                with self._lock:
                    self._in_flight -= 1
                self._notify()

    def _execute(self, req: StageRequest) -> None:
        name = req.ref.name
        if name not in self.data:
            raise KeyError(f"staging request for unknown dataset {name!r}")
        if req.kind == "out":
            nbytes = self.data.spool_out(
                name, link=req.ref.link(Link.GFS),
                reason=req.reason or f"stage-out:{name}")
            if req.ref.evict_after:
                # cold tiering: the archive replica just landed, so the
                # local copy is droppable (keep_last still guards the
                # degenerate non-GFS case where no archive was left)
                if self.data.drop_replica(name, self.pilot.uid,
                                          keep_last=True):
                    self.cache.forget(name)
            with self._lock:
                self.stats["stage_outs"] += 1
                self.stats["bytes_moved"] += nbytes
            req._resolve(StageState.DONE, nbytes)
            return
        pilot = self.pilot
        with self._lock:
            name_lock = self._name_locks.setdefault(name, threading.Lock())
        with name_lock:
            nonres = self.data.bytes_nonresident([name], pilot.uid,
                                                 pilot.devices)
            if nonres == 0:
                # replica already here — the short-circuit local read
                req.hit = True
                self.cache.stats["hits"] += 1
                self.cache.touch(name)
                req._resolve(StageState.DONE, 0)
                return
            self.cache.stats["misses"] += 1
            sharding = replicated_sharding(pilot.devices)
            _, wire = self.data.replicate_to(
                name, pilot.uid, sharding, link=req.ref.link(Link.DCN),
                reason=req.reason or f"prefetch:{name}",
                compress=req.ref.compress,
                min_compress_bytes=self.min_compress_bytes)
            self.cache.admit(name, self.data.get(name).nbytes)
        with self._lock:
            self.stats["transfers"] += 1
            self.stats["bytes_moved"] += wire
        req._resolve(StageState.DONE, wire)

    def _notify(self) -> None:
        cb = self.notify
        if cb is not None:
            cb()

    # ---------------------------------------------------------------- state
    @property
    def backlog(self) -> int:
        """Requests queued or in flight — the staging pressure signal."""
        with self._lock:
            return self._q.qsize() + self._in_flight

    @property
    def active(self) -> bool:
        return self.backlog > 0

    def snapshot(self) -> Dict[str, Any]:
        """Heartbeat export: backlog + transfer stats + cache pressure."""
        with self._lock:
            stats = dict(self.stats)
            backlog = self._q.qsize() + self._in_flight
        return {"backlog": backlog, **stats, "cache": self.cache.snapshot()}

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for t in self._workers:
            t.join(timeout=timeout)
        # resolve whatever is still queued so no consumer hangs forever
        while True:
            try:
                _, _, req = self._q.get_nowait()
            except queue.Empty:
                break
            if req.try_transition(StageState.PENDING, StageState.FAILED):
                req._resolve(StageState.FAILED,
                             error=RuntimeError("prefetcher stopped"))
