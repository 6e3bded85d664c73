"""Session: the application-facing unifying resource layer.

The paper's pilot abstraction promises "a unified resource layer over
heterogeneous allocations" — HPC stages and analytics stages of one
application, coupled through shared data.  The seed code answered the
locality-vs-movement question only *within* a single pilot (scheduler
delay scheduling, `ensure_local`).  The Session answers it *across*
pilots:

  * owns a :class:`PilotManager` and registers heterogeneous pilots —
    ``runtime='hpc'`` (gang-scheduled MPI-like stages) and
    ``runtime='analytics'`` (long-lived MapReduce runtime, Mode II);
    all pilots share ONE :class:`DataPlane`;
  * executes a **stage DAG** (:func:`hpc_stage` / :func:`analytics_stage`
    nodes with named data dependencies) asynchronously via futures —
    a stage becomes ready when its producers finish;
  * a **placer** scores each ready stage on every compatible pilot as

        affinity + locality_score − movement_cost(bytes, link)
                 − est_runtime(cost, pilot)

    where affinity is the consolidation pull toward a native-runtime
    pilot, locality is the DataPlane's byte-weighted replica score,
    movement_cost prices the non-resident bytes over the inter-pilot
    DCN link, and est_runtime is the roofline ``max(compute, memory)``
    time of the stage's (optional) :class:`~repro_torch.roofline.
    placement.StageCost` on that pilot's advertised per-chip peak
    FLOP/s + HBM bandwidth — so a compute-bound stage and a memory-
    bound stage with identical bytes land on *different* pilots.  After
    each run the estimate is cross-checked against the actual wall time
    (and the agent's EMA runtimes); the error rides the pilot heartbeat
    so model drift is observable from the ControlPlane.  The stage then
    either runs where its data lives (an analytics stage on an HPC pilot
    carves a Mode-I cluster) or the data moves — the paper's Fig-8
    local-disk-vs-Lustre trade-off as a first-class, queryable runtime
    decision (``session.placements``).

Every stage runs on a thread of the Session's executor and its CU on an
agent thread: tensors a stage makes land on its pilot's device, and a
kernel a stage calls launches on that thread's current stream, the
device's default stream.  A stage's exception reaches :meth:`Session.run`
through its future.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import math
import os
import pickle
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from .compute_unit import ComputeUnitDescription
from .dataplane import (DataPlane, GFS_ARCHIVE, Lineage, Link,
                        ShardedTensor, TransferCostModel, place,
                        replicated_sharding)
from .pilot import Pilot, PilotDescription, PilotManager, PilotState
from .resource_manager import ResourceManager
from .staging import DataRef, as_refs
from ..roofline.placement import StageCost, est_runtime, estimate_error

HPC = "hpc"
ANALYTICS = "analytics"


def _as_tensor(val: Any) -> Any:
    """A stage output as something :func:`place` lays out: tensors and
    ShardedTensors as they are, numpy arrays (bf16 included) with their
    dtype, Python numbers as 0-d tensors of torch's default dtypes."""
    if isinstance(val, (torch.Tensor, ShardedTensor)):
        return val
    if isinstance(val, (bool, int, float)):
        return torch.tensor(val)
    return convert.to_tensor(np.asarray(val))


def _to_host(tree: Any) -> Any:
    """`tree` (dicts, lists, tuples) with every tensor a numpy array."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, ShardedTensor):
        return convert.to_numpy(tree.full())
    if isinstance(tree, torch.Tensor):
        return convert.to_numpy(tree)
    return tree


def _npz_array(arr: np.ndarray) -> np.ndarray:
    """An array read back from ``data.npz``: numpy stores a bfloat16
    array (``ml_dtypes``) as raw 2-byte records, which are its bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        import ml_dtypes
        return arr.view(ml_dtypes.bfloat16)
    return arr


@dataclasses.dataclass
class Stage:
    """One node of the application DAG.

    ``fn`` is called with keyword arguments: each declared input name
    bound to its (locality-ensured) tensor — the whole dataset on the
    first device of its placement, the chosen pilot's own copy — plus,
    when the signature accepts them, ``mesh`` (HPC stages, the pilot's
    :class:`~repro_torch.core.dataplane.DeviceGrid`), ``engine``
    (analytics stages) and ``results`` (dict of completed stages'
    return values).  The return value is stored under
    ``session.run(...)[name]``; array entries of a dict return that
    match ``outputs`` are published to the DataPlane with lineage,
    replicated over the producing pilot's devices (numpy arrays,
    tensors and Python numbers are accepted).
    """
    name: str
    fn: Callable[..., Any]
    kind: str                           # HPC | ANALYTICS
    inputs: Tuple[str, ...] = ()        # DataPlane names this stage reads
    outputs: Tuple[str, ...] = ()       # DataPlane names this stage produces
    after: Tuple[str, ...] = ()         # extra control deps (stage names)
    n_chips: Optional[int] = None       # default: the whole pilot
    pilot: Optional[str] = None         # pin to a pilot by name (optional)
    gang: bool = True
    tenant: Optional[str] = None        # submitting tenant (set by contexts)
    queue: Optional[str] = None         # tenant queue for the stage's CUs
    # declarative staging overrides: DataRefs refining how ``inputs``
    # are promoted (link hint, wire compression) and which outputs are
    # spooled out after the stage (GFS archive).  Names not in
    # ``inputs`` are staged in addition.
    stage_in: Tuple = ()
    stage_out: Tuple = ()
    # optional roofline cost descriptor (global FLOPs + HBM bytes): the
    # placer converts it to an est_runtime on each candidate pilot's
    # advertised speeds and subtracts it from the score.  None:
    # byte-only scoring (legacy).
    cost: Optional[StageCost] = None


def hpc_stage(name: str, fn: Callable, **kw) -> Stage:
    """An MPI-like stage: gang-scheduled CU on an HPC-runtime pilot."""
    return Stage(name=name, fn=fn, kind=HPC, **kw)


def analytics_stage(name: str, fn: Callable, **kw) -> Stage:
    """A MapReduce-like stage: runs natively on an analytics-runtime
    pilot, or via a Mode-I carve-out inside an HPC pilot."""
    return Stage(name=name, fn=fn, kind=ANALYTICS, **kw)


class TenantContext:
    """One tenant's view of a Session: stages submitted through it are
    tagged with the tenant's name and queue (so every CU lands in the
    tenant's queue on whichever pilot the placer picks), and an optional
    ``max_concurrent_stages`` budget gates admission — the Session-level
    analogue of YARN's per-user limits.  Obtain via
    :meth:`Session.tenant`."""

    def __init__(self, session: "Session", name: str, *,
                 queue: Optional[str] = None,
                 max_concurrent_stages: Optional[int] = None):
        if max_concurrent_stages is not None and max_concurrent_stages < 1:
            raise ValueError("max_concurrent_stages must be >= 1")
        self.session = session
        self.name = name
        self.queue = queue or name
        self.max_concurrent_stages = max_concurrent_stages
        self._sem = (threading.BoundedSemaphore(max_concurrent_stages)
                     if max_concurrent_stages else None)
        self.stats = {"submitted": 0, "completed": 0}

    def tag(self, stages: Sequence[Stage]) -> List[Stage]:
        """Stages re-bound to this tenant (name + queue)."""
        return [dataclasses.replace(s, tenant=self.name,
                                    queue=s.queue or self.queue)
                for s in stages]

    def submit_dag(self, stages: Sequence[Stage], **kw) -> Dict[str, Future]:
        tagged = self.tag(stages)
        self.stats["submitted"] += len(tagged)
        return self.session.submit_dag(tagged, **kw)

    def run(self, stages: Sequence[Stage], **kw) -> Dict[str, Any]:
        tagged = self.tag(stages)
        self.stats["submitted"] += len(tagged)
        return self.session.run(tagged, **kw)

    def map(self, fn: Callable, items: Sequence, **kw) -> List[Any]:
        """Tenant-scoped :meth:`Session.map`: every micro-task is
        charged to this tenant's queue (caps/fairness apply)."""
        kw.setdefault("queue", self.queue)
        return self.session.map(fn, items, tenant=self.name, **kw)


class Session:
    def __init__(self, rm: Optional[ResourceManager] = None, *,
                 cost_model: Optional[TransferCostModel] = None,
                 prefetch: bool = False,
                 roofline_placement: bool = True,
                 calibrate_estimates: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_interval_s: float = 0.0):
        self.cost_model = cost_model or TransferCostModel()
        self.dataplane = DataPlane(cost_model=self.cost_model)
        # prefetch=True routes stage inputs through each pilot's async
        # staging pipeline (placement-time enqueue, delay scheduling)
        # instead of the synchronous move in _ensure_inputs_on
        self.prefetch = prefetch
        # roofline_placement=False drops the est_runtime term (byte-only
        # scoring — the on/off arm of bench_autotune); stages carrying
        # no StageCost are byte-only either way.  calibrate_estimates
        # additionally multiplies each pilot's est_runtime by that
        # pilot's observed EMA actual/estimate ratio — off by default:
        # the error is always EXPORTED (heartbeats + placements), it is
        # only APPLIED on request.
        self.roofline_placement = roofline_placement
        self.calibrate_estimates = calibrate_estimates
        self.pm = PilotManager(rm)
        self.control_plane = self.pm.control_plane  # elastic rebalancing
        self.pilots: Dict[str, Pilot] = {}          # pilot name -> Pilot
        self.results: Dict[str, Any] = {}           # stage name -> return
        self.placements: Dict[str, Dict[str, Any]] = {}
        self._stages: Dict[str, Stage] = {}         # for rematerialization
        self._engines: Dict[str, Any] = {}          # pilot uid -> engine
        self._tenants: Dict[str, TenantContext] = {}
        self._overlays: Dict[str, Any] = {}         # pilot uid -> RaptorMaster
        self._routers: List[Any] = []               # serve_pool routers
        self._pre_staged: Dict[str, Tuple] = {}     # stage -> (pilot, dec, reqs)
        self._lock = threading.Lock()
        self._move_lock = threading.Lock()          # serializes input moves
        # session checkpoint/resume (Hadoop analogue: RM/AM restart with
        # work-preserving recovery): a periodic journal of DAG state —
        # completed stages, placements, DataPlane contents + lineage —
        # so Session.resume(dir) continues without re-running stages
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval_s = checkpoint_interval_s
        # the first stage to finish journals: a monotonic clock starts
        # near 0 at boot, so a 0.0 start would hold the first write
        # back until the machine had been up for one interval
        self._last_ckpt = -math.inf
        self._ckpt_lock = threading.Lock()
        self._restored_stages: set = set()          # completed pre-resume
        self._restore_manifest: Optional[Tuple[str, Dict[str, Any]]] = None

    # ------------------------------------------------------------- tenants
    def tenant(self, name: str, *, queue: Optional[str] = None,
               max_concurrent_stages: Optional[int] = None) -> TenantContext:
        """Register (or fetch) a tenant context.  Stages submitted
        through it carry the tenant's name/queue down to every CU, and
        at most ``max_concurrent_stages`` of its stages run at once."""
        with self._lock:
            ctx = self._tenants.get(name)
            if ctx is None:
                ctx = TenantContext(
                    self, name, queue=queue,
                    max_concurrent_stages=max_concurrent_stages)
                self._tenants[name] = ctx
            elif ((queue is not None and queue != ctx.queue)
                  or (max_concurrent_stages is not None
                      and max_concurrent_stages
                      != ctx.max_concurrent_stages)):
                raise ValueError(
                    f"tenant {name!r} already registered with queue="
                    f"{ctx.queue!r}, max_concurrent_stages="
                    f"{ctx.max_concurrent_stages} — re-registration with "
                    "different settings would silently not apply")
            return ctx

    # -------------------------------------------------------------- pilots
    def add_pilot(self, desc: PilotDescription) -> Pilot:
        """Register a pilot; all Session pilots share the DataPlane."""
        if desc.name in self.pilots:
            raise ValueError(f"pilot name {desc.name!r} already registered "
                             "(names key the placer's candidate set)")
        pilot = self.pm.submit(desc, data_registry=self.dataplane)
        self.pilots[desc.name] = pilot
        return pilot

    def pilots_by_runtime(self, runtime: str) -> List[Pilot]:
        # FAILED pilots (heartbeat death) stay registered — their name
        # and timings matter for postmortems — but are never candidates
        return [p for p in self.pilots.values()
                if p.desc.runtime == runtime
                and p.state is PilotState.ACTIVE]

    def shutdown(self) -> None:
        with self._lock:
            routers, self._routers = list(self._routers), []
            overlays, self._overlays = list(self._overlays.values()), {}
        for r in routers:
            r.stop()
        for m in overlays:
            m.shutdown(drain=True, timeout=30.0)
        self.pm.shutdown()

    # ----------------------------------------------------------- micro-tasks
    def _overlay_for(self, pilot: Optional[str],
                     n_workers: Optional[int]):
        """The Session's per-pilot Raptor overlay (created on first use,
        reused after — the whole point is amortizing admission).  The
        overlay's own gang CU is tenant-neutral (default queue); each
        micro-task carries its submitter's tenant/queue."""
        if pilot is not None:
            target = self.pilots[pilot]
        else:
            cands = self.pilots_by_runtime(HPC) or list(self.pilots.values())
            if not cands:
                raise RuntimeError("session has no pilots to host an overlay")
            # prefer an existing overlay's host, else the most-free pilot
            with self._lock:
                hosted = [p for p in cands if p.uid in self._overlays
                          and self._overlays[p.uid].alive]
            target = hosted[0] if hosted else max(
                cands, key=lambda p: p.agent.scheduler.n_free)
        with self._lock:
            master = self._overlays.get(target.uid)
        if master is not None and master.alive:
            return master
        n = n_workers or max(1, target.agent.scheduler.n_slots // 2)
        master = target.spawn_raptor(n)
        with self._lock:
            self._overlays[target.uid] = master
        return master

    def map(self, fn: Callable, items: Sequence, *,
            tenant: Optional[str] = None, queue: Optional[str] = None,
            pilot: Optional[str] = None, n_workers: Optional[int] = None,
            tag: str = "map", timeout: float = 600.0) -> List[Any]:
        """Run ``fn(item)`` for each item as Raptor micro-tasks — no
        per-item CU admission — and return the results in item order.
        The first call lazily starts an overlay on ``pilot`` (or the
        freest HPC pilot) and later calls reuse it; every micro-task is
        charged to ``tenant``'s queue while it runs, so DRF/Capacity
        caps hold over micro-task load too."""
        master = self._overlay_for(pilot, n_workers)
        tasks = master.map(fn, items, tenant=tenant, queue=queue, tag=tag)
        return [t.wait(timeout) for t in tasks]

    # -------------------------------------------------------------- serving
    def serve_pool(self, backend_factory: Callable[[], Any], *,
                   n_engines: int = 2, slots: int = 4, max_seq: int = 256,
                   prompt_bucket: int = 32,
                   decode_pilots: Optional[Sequence[str]] = None,
                   prefill_pilot: Optional[str] = None,
                   prefill_workers: Optional[int] = None,
                   offload_prefill: bool = True,
                   queue_configs: Optional[Sequence] = None,
                   page_tokens: int = 16,
                   bytes_per_token: Optional[int] = None,
                   kv_itemsize: int = 2, cfg=None,
                   compress: Optional[str] = None, **router_kw):
        """Disaggregated serving on this session's pilots.

        Decode engines (long-lived batch loops — the serving analogue of
        a long-running AM) land one per pilot in ``decode_pilots``, else
        on the freest pilots; prefill runs as Raptor micro-tasks on
        ``prefill_pilot`` (default: the freest non-decode pilot — the
        compute-heavy side of the split).  Every request's KV-cache is
        paged on the shared DataPlane and the returned
        :class:`~repro_torch.serve.router.ServeRouter` dispatches by
        ``locality − movement_cost − load`` over that residency, with
        per-tenant DRF budgets (``queue_configs``) binding across ALL
        engines through one QueueTree."""
        from .queues import QueueTree
        from ..serve.engine import ServeEngine
        from ..serve.kv_pages import KVPageManager
        from ..serve.router import DrfAdmission, EngineHandle, ServeRouter

        if decode_pilots is not None:
            decos = [self.pilots[n] for n in decode_pilots]
            n_engines = len(decos)
        else:
            ranked = sorted(self.pilots.values(), reverse=True,
                            key=lambda p: p.agent.scheduler.n_free)
            if not ranked:
                raise RuntimeError("session has no pilots for a serve pool")
            decos = [ranked[i % len(ranked)] for i in range(n_engines)]

        kv = KVPageManager(self.dataplane, page_tokens=page_tokens,
                           bytes_per_token=bytes_per_token,
                           itemsize=kv_itemsize, cfg=cfg, compress=compress)
        tree = QueueTree(queue_configs)
        admission = DrfAdmission(
            tree, slots_total=n_engines * slots,
            kv_bytes_total=n_engines * slots * kv.bytes_for_tokens(max_seq))

        handles = []
        for i, pilot in enumerate(decos):
            engine = ServeEngine(
                cfg, backend=backend_factory(), slots=slots,
                max_seq=max_seq, prompt_bucket=prompt_bucket,
                admission=admission,
                name=f"decode{i}@{pilot.desc.name}")
            pilot.agent.register_serve(engine)
            handles.append(EngineHandle(engine, pilot.uid))

        if prefill_pilot is not None:
            ppilot = self.pilots[prefill_pilot]
        else:
            outside = [p for p in self.pilots.values() if p not in decos]
            ppilot = max(outside or list(self.pilots.values()),
                         key=lambda p: p.agent.scheduler.n_free)
        overlay = (self._overlay_for(ppilot.desc.name, prefill_workers)
                   if offload_prefill else None)
        prefill_backend = backend_factory()
        router = ServeRouter(
            handles, kv, self.cost_model,
            prefill_fn=prefill_backend.prefill, prefill_pilot=ppilot.uid,
            bucket=prompt_bucket, overlay=overlay, **router_kw)
        router.admission = admission        # bench/test observability
        with self._lock:
            self._routers.append(router)
        return router

    # -------------------------------------------------------------- placer
    def _compatible(self, stage: Stage) -> List[Pilot]:
        if stage.pilot is not None:
            pinned = self.pilots[stage.pilot]
            if pinned.state is PilotState.ACTIVE:
                return [pinned]
            # the pinned pilot died: fall through to the normal candidate
            # set — a rematerialized stage must land on a survivor
        if stage.kind == HPC:
            return self.pilots_by_runtime(HPC)
        return [p for p in self.pilots.values()      # analytics: native
                if p.state is PilotState.ACTIVE]     # or Mode I

    def score(self, stage: Stage, pilot: Pilot) -> Dict[str, float]:
        """The placer objective, reported term by term."""
        loc = self.dataplane.pilot_locality(stage.inputs, pilot.uid,
                                            pilot.devices)
        nbytes = self.dataplane.bytes_nonresident(stage.inputs, pilot.uid,
                                                  pilot.devices)
        move = self.cost_model.movement_cost(nbytes, Link.DCN)
        affinity = (self.cost_model.runtime_affinity
                    if pilot.desc.runtime == stage.kind else 0.0)
        entry = {"locality": loc, "bytes_to_move": float(nbytes),
                 "movement_cost": move, "affinity": affinity,
                 "total": affinity + loc - move}
        if stage.cost is not None and self.roofline_placement:
            # roofline term: the stage's FLOPs/HBM bytes over the chips
            # it would hold on THIS pilot, at this pilot's advertised
            # speeds.  Seconds, same unit movement_cost already uses.
            n = stage.n_chips or max(self._effective_chips(pilot), 1)
            rt = est_runtime(stage.cost, n_chips=n,
                             peak_flops=pilot.desc.peak_flops_per_chip,
                             hbm_bw=pilot.desc.hbm_bw_per_chip)
            est = rt["est_s"]
            if self.calibrate_estimates:
                ratio = pilot.agent.estimate_calibration()
                if ratio is not None:
                    est *= ratio
                    entry["calibration_ratio"] = ratio
            entry.update({"compute_s": rt["compute_s"],
                          "memory_s": rt["memory_s"],
                          "bound": rt["bound"], "est_runtime": est})
            entry["total"] -= est
        return entry

    def _effective_chips(self, pilot: Pilot) -> int:
        """Capacity the placer may count on: the pilot's slice minus any
        chips an in-flight ControlPlane resize is already draining away
        (pending grows are not counted until the slots actually land)."""
        delta = self.control_plane.pending_delta(pilot.uid)
        return len(pilot.devices) + min(0, delta)

    def place(self, stage: Stage) -> Tuple[Pilot, Dict[str, Any]]:
        cands = self._compatible(stage)
        if not cands:
            raise RuntimeError(
                f"no compatible pilot for {stage.kind} stage {stage.name!r}")
        need = stage.n_chips or 1
        fits = [p for p in cands if self._effective_chips(p) >= need]
        rebalanced = 0
        if not fits:
            # unplaceable as-is: ask the ControlPlane to reshape the
            # pilot set — free the deficit from the coldest pilots and
            # grant it to the best-scoring candidate
            target = max(cands, key=lambda p: self.score(stage, p)["total"])
            rebalanced = self.control_plane.grow(
                target, need - self._effective_chips(target),
                reason=f"stage:{stage.name}")
            if self._effective_chips(target) >= need:
                fits = [target]
        if not fits:
            fits = cands        # last resort: legacy behavior (a gang CU
            #                     too big for every pilot fails fast below)
        scored = [(self.score(stage, p), p) for p in fits]
        best_score, best = max(scored, key=lambda sp: sp[0]["total"])
        decision = {"pilot": best.desc.name, "pilot_uid": best.uid,
                    "scores": {p.desc.name: s for s, p in scored},
                    "chosen": best_score}
        if rebalanced:
            decision["rebalanced_chips"] = rebalanced
        return best, decision

    # ----------------------------------------------------------------- DAG
    @staticmethod
    def _producers(stages: Sequence[Stage]) -> Dict[str, List[str]]:
        """Stage name -> names of stages it depends on (data + control)."""
        by_output: Dict[str, str] = {}
        for s in stages:
            for out in s.outputs:
                if out in by_output:
                    raise ValueError(f"output {out!r} produced twice")
                by_output[out] = s.name
        deps: Dict[str, List[str]] = {}
        for s in stages:
            d = [by_output[i] for i in s.inputs if i in by_output]
            d += [a for a in s.after]
            deps[s.name] = sorted(set(d))
        return deps

    @staticmethod
    def _topo_order(stages: Sequence[Stage],
                    deps: Dict[str, List[str]]) -> List[Stage]:
        by_name = {s.name: s for s in stages}
        order, seen, visiting = [], set(), set()

        def visit(name: str) -> None:
            if name in seen:
                return
            if name in visiting:
                raise ValueError(f"stage DAG has a cycle through {name!r}")
            visiting.add(name)
            for d in deps.get(name, ()):
                if d in by_name:
                    visit(d)
            visiting.discard(name)
            seen.add(name)
            order.append(by_name[name])

        try:
            for s in stages:
                visit(s.name)
        finally:
            del visit      # the recursive closure is a cycle of its own
        return order

    def submit_dag(self, stages: Sequence[Stage], *,
                   timeout: float = 600.0) -> Dict[str, Future]:
        """Launch the DAG; returns one future per stage (async API)."""
        known = {s.name for s in stages} | set(self.results)
        for s in stages:
            bad = [a for a in s.after if a not in known]
            if bad:
                raise ValueError(
                    f"stage {s.name!r} waits on unknown stage(s) {bad}")
        self._restore_data()       # lazy half of resume (no-op otherwise)
        deps = self._producers(stages)
        ordered = self._topo_order(stages, deps)
        with self._lock:
            for s in ordered:
                self._stages[s.name] = s
        if self.prefetch:
            self._pre_stage(ordered)
        ex = ThreadPoolExecutor(max_workers=max(4, len(ordered)),
                                thread_name_prefix="session-stage")
        futures: Dict[str, Future] = {}
        for s in ordered:
            if s.name in self._restored_stages:
                # resumed session: this stage completed before the crash
                # — hand back its checkpointed result, do not re-run
                fut: Future = Future()
                fut.set_result(self.results.get(s.name))
                futures[s.name] = fut
                continue
            dep_futs = [futures[d] for d in deps[s.name] if d in futures]
            futures[s.name] = ex.submit(self._run_stage, s, dep_futs, timeout)
        ex.shutdown(wait=False)
        return futures

    def run(self, stages: Sequence[Stage], *,
            timeout: float = 600.0) -> Dict[str, Any]:
        """Execute the DAG to completion; returns stage name -> result."""
        futures = self.submit_dag(stages, timeout=timeout)
        return {name: f.result(timeout) for name, f in futures.items()}

    # ------------------------------------------------------------- staging
    def _stage_in_refs(self, stage: Stage) -> List[DataRef]:
        """The stage's effective stage-in set: every declared input as a
        plain DataRef, refined (link hint / compression) by any matching
        ``stage.stage_in`` entry; stage_in names outside ``inputs`` are
        staged in addition."""
        by_name = {r.name: r for r in as_refs(stage.stage_in)}
        refs = [by_name.pop(n, DataRef(n)) for n in stage.inputs]
        return refs + list(by_name.values())

    def _prefetch_for(self, stage: Stage, pilot: Pilot) -> List:
        """Enqueue async tier promotion of the stage's inputs onto the
        chosen pilot (placement-decision time) — transfers overlap
        whatever is still running there."""
        refs = self._stage_in_refs(stage)
        for r in refs:
            if r.name not in self.dataplane:
                raise KeyError(f"stage {stage.name!r} input {r.name!r} "
                               "not in DataPlane")
        if pilot.prefetcher is None:
            return []
        return pilot.prefetcher.request_many(
            refs, reason=f"stage:{stage.name}")

    def _pre_stage(self, ordered: Sequence[Stage]) -> None:
        """Eager placement + prefetch for stages whose inputs all exist
        already (none produced by this DAG): their transfers start at
        submit time, overlapping the predecessors ``after`` chains them
        behind.  The placement decision is stashed and consumed by
        :meth:`_run_stage` when the stage's turn comes."""
        produced = {out for s in ordered for out in s.outputs}
        for s in ordered:
            if not s.inputs or any(i in produced for i in s.inputs):
                continue
            if not all(i in self.dataplane for i in s.inputs):
                continue
            try:
                pilot, decision = self.place(s)
            except RuntimeError:
                continue          # no compatible pilot: fail at run time
            reqs = self._prefetch_for(s, pilot)
            decision["pre_staged"] = True
            with self._lock:
                self._pre_staged[s.name] = (pilot, decision, reqs)

    # ------------------------------------------------------------ execution
    def _run_stage(self, stage: Stage, dep_futs: Sequence[Future],
                   timeout: float) -> Any:
        for f in dep_futs:                     # propagate producer failures
            f.result(timeout)
        ctx = self._tenants.get(stage.tenant) if stage.tenant else None
        if ctx is not None and ctx._sem is not None:
            # per-tenant admission: at most max_concurrent_stages in
            # flight; excess stages wait here, not in a pilot's queue
            if not ctx._sem.acquire(timeout=timeout):
                raise TimeoutError(
                    f"tenant {stage.tenant!r} admission budget "
                    f"({ctx.max_concurrent_stages}) not freed within "
                    f"{timeout}s for stage {stage.name!r}")
        try:
            with self._lock:
                pre = self._pre_staged.pop(stage.name, None)
            if pre is not None:
                pilot, decision, staging = pre
            else:
                pilot, decision = self.place(stage)
                staging = (self._prefetch_for(stage, pilot)
                           if self.prefetch else None)
            if stage.tenant:
                decision["tenant"] = stage.tenant
                decision["queue"] = stage.queue
            if staging is None:
                self._ensure_inputs_on(stage, pilot, decision)
            t_run = time.monotonic()
            # thread the placer's roofline estimate into the CU so the
            # straggler watchdog has a baseline before any EMA history
            est = decision.get("chosen", {}).get("est_runtime")
            if stage.kind == HPC:
                result = self._run_hpc(stage, pilot, timeout,
                                       staging=staging, est_s=est)
            else:
                result = self._run_analytics(stage, pilot, decision, timeout,
                                             staging=staging, est_s=est)
            self._cross_check_estimate(stage, pilot, decision,
                                       time.monotonic() - t_run)
            if staging is not None:
                decision["dcn_bytes_moved"] = sum(r.wire_bytes
                                                  for r in staging)
                decision["staging_hits"] = sum(1 for r in staging if r.hit)
        finally:
            if ctx is not None and ctx._sem is not None:
                ctx._sem.release()
        if ctx is not None:
            ctx.stats["completed"] += 1
        self._store_outputs(stage, pilot, result)
        if stage.stage_out and pilot.prefetcher is not None:
            # spool declared outputs to the GFS archive tier — off the
            # critical path; the stage result is already published
            pilot.prefetcher.request_many(
                stage.stage_out, kind="out",
                reason=f"stage-out:{stage.name}")
        with self._lock:
            self.results[stage.name] = result
            self.placements[stage.name] = decision
        self._maybe_checkpoint()
        return result

    def _ensure_inputs_on(self, stage: Stage, pilot: Pilot,
                          decision: Dict[str, Any]) -> None:
        """Movement side of the placement decision: any input not
        resident on the chosen pilot crosses the DCN link (recorded)."""
        moved = 0
        for name in stage.inputs:
            if name not in self.dataplane:
                raise KeyError(f"stage {stage.name!r} input {name!r} "
                               "not in DataPlane")
            # serialize check-then-move: concurrent consumer stages must
            # not double-move (and double-count) a shared input
            with self._move_lock:
                if self.dataplane.resident_on(name, pilot.uid) is False:
                    sharding = replicated_sharding(pilot.devices)
                    _, nbytes = self.dataplane.move_to_pilot(
                        name, pilot.uid, sharding, link=Link.DCN,
                        reason=f"stage:{stage.name}")
                    moved += nbytes
        decision["dcn_bytes_moved"] = moved

    def _cross_check_estimate(self, stage: Stage, pilot: Pilot,
                              decision: Dict[str, Any],
                              actual_s: float) -> None:
        """Close the roofline loop: compare the chosen pilot's
        est_runtime against the measured stage wall time (which the
        agent's per-tag EMA also tracks), record both in the placement
        decision, and push the error onto the agent so it rides the
        pilot's heartbeat — ControlPlane polls see model drift."""
        est = decision.get("chosen", {}).get("est_runtime")
        if est is None:
            return
        decision["est_runtime_s"] = est
        decision["actual_runtime_s"] = actual_s
        err = estimate_error(est, actual_s)
        if err is not None:
            decision["est_error_ratio"] = err
        pilot.agent.record_estimate(f"stage:{stage.name}", est, actual_s)

    def _call_kwargs(self, stage: Stage, extra: Dict[str, Any]) -> Dict[str, Any]:
        kwargs = {n: self.dataplane.get(n).array.full() for n in stage.inputs}
        params = inspect.signature(stage.fn).parameters
        has_var = any(p.kind is inspect.Parameter.VAR_KEYWORD
                      for p in params.values())
        for k, v in extra.items():
            if has_var or k in params:
                kwargs[k] = v
        if has_var or "results" in params:
            with self._lock:
                kwargs["results"] = dict(self.results)
        return kwargs

    @staticmethod
    def _app_id(stage: Stage) -> str:
        """AppMaster-sharing key: stages of one kind share an app, but
        never across tenants (reuse must not leak between tenants)."""
        return (f"session:{stage.kind}"
                + (f":{stage.tenant}" if stage.tenant else ""))

    def _run_hpc(self, stage: Stage, pilot: Pilot, timeout: float,
                 staging: Optional[Sequence] = None,
                 est_s: Optional[float] = None) -> Any:
        # whole-pilot stages size to the scheduler's LIVE slot count, not
        # len(devices): chips draining away are still in the device list
        # but a gang that counts them would fail fast
        n = stage.n_chips or max(pilot.agent.scheduler.n_slots, 1)

        def job(mesh=None):
            return stage.fn(**self._call_kwargs(stage, {"mesh": mesh}))

        cu = pilot.submit(ComputeUnitDescription(
            fn=job, gang=stage.gang, n_chips=n, tag=f"stage:{stage.name}",
            data=tuple(stage.inputs), app_id=self._app_id(stage),
            tenant=stage.tenant, queue=stage.queue,
            est_runtime_s=est_s), staging=staging)
        # follow(): a ControlPlane drain may preempt the CU and forward
        # to a re-queued clone — the stage result is the chain's end
        return cu.follow(timeout)

    def _run_analytics(self, stage: Stage, pilot: Pilot,
                       decision: Dict[str, Any], timeout: float,
                       staging: Optional[Sequence] = None,
                       est_s: Optional[float] = None) -> Any:
        if pilot.desc.runtime == ANALYTICS:
            engine = self._engine_for(pilot)
            decision["mode"] = "native"

            def job(mesh=None):
                return stage.fn(**self._call_kwargs(stage, {"engine": engine}))

            cu = pilot.submit(ComputeUnitDescription(
                fn=job, gang=stage.gang,
                n_chips=stage.n_chips
                or max(pilot.agent.scheduler.n_slots, 1),
                tag=f"stage:{stage.name}", data=tuple(stage.inputs),
                needs_mesh=False, app_id=self._app_id(stage),
                tenant=stage.tenant, queue=stage.queue,
                est_runtime_s=est_s), staging=staging)
            return cu.follow(timeout)
        # Mode I: carve an on-demand analytics cluster out of the HPC
        # pilot holding the data (compute goes to the data).  The carve
        # path has no CU to delay-schedule, so in-flight staging is
        # awaited here (the transfers still overlapped the predecessor).
        if staging:
            for r in staging:
                r.wait(timeout)
        decision["mode"] = "mode1-carve"
        n = stage.n_chips or len(pilot.devices)
        cluster = pilot.spawn_analytics_cluster(n, tenant=stage.tenant,
                                                queue=stage.queue)
        decision["mode1_spawn_s"] = cluster.startup_s
        try:
            return stage.fn(
                **self._call_kwargs(stage, {"engine": cluster.engine}))
        finally:
            cluster.shutdown()

    def _engine_for(self, pilot: Pilot):
        from ..analytics.engine import AnalyticsEngine
        # keyed by the pilot's CURRENT device slice: an elastic resize
        # invalidates the cached engine, whose mesh would otherwise keep
        # pointing at chips the lease no longer covers
        key = tuple(id(d) for d in pilot.devices)
        with self._lock:
            cached = self._engines.get(pilot.uid)
            if cached is None or cached[0] != key:
                cached = (key, AnalyticsEngine(pilot.mesh(), self.dataplane))
                self._engines[pilot.uid] = cached
        return cached[1]

    def _store_outputs(self, stage: Stage, pilot: Pilot, result: Any) -> None:
        """Publish declared outputs to the DataPlane, homed on the pilot
        that produced them, with lineage for re-materialization."""
        if not stage.outputs:
            return
        if isinstance(result, dict):
            pairs = [(n, result.get(n)) for n in stage.outputs]
        elif len(stage.outputs) == 1:
            pairs = [(stage.outputs[0], result)]
        else:
            pairs = list(zip(stage.outputs, result))
        missing = [n for n in stage.outputs
                   if n not in dict(pairs) or dict(pairs)[n] is None]
        if missing:
            raise ValueError(
                f"stage {stage.name!r} declared outputs {missing} but did "
                "not return them")
        lineage = Lineage(stage=stage.name, inputs=tuple(stage.inputs))
        # the pool's own device objects (placements match by identity)
        sharding = replicated_sharding(pilot.devices)
        for name, val in pairs:
            arr = place(_as_tensor(val), sharding)
            self.dataplane.put(name, arr, pilot=pilot.uid, lineage=lineage)

    # ------------------------------------------------------------- recovery
    def rematerialize(self, name: str, *, timeout: float = 600.0) -> Any:
        """Re-run the producer of a lost dataset (lineage recovery): the
        DataPlane remembers how `name` was made; the placer re-places the
        producing stage with the current pilot set."""
        lin = self.dataplane.lineage_of(name)
        if lin is None or lin.stage not in self._stages:
            raise KeyError(f"no lineage for {name!r}")
        stage = self._stages[lin.stage]
        return self._run_stage(stage, (), timeout)

    # ------------------------------------------------------ fault tolerance
    def enable_fault_tolerance(self, *, heartbeat_timeout_s: float = 1.0,
                               suspect_grace_s: Optional[float] = None,
                               start_interval_s: Optional[float] = None
                               ) -> None:
        """Arm heartbeat-deadline failure detection on the ControlPlane
        and wire its recovery hooks back into this Session: lost
        datasets rematerialize through lineage, orphaned Raptor
        micro-tasks resubmit on a surviving overlay, and serve routers
        move a dead pilot's requests onto surviving engines.  Pass
        ``start_interval_s`` to also start the autonomous control loop
        (detection then runs without any explicit ``check_failures``
        call)."""
        cp = self.control_plane
        cp.heartbeat_timeout_s = heartbeat_timeout_s
        cp.suspect_grace_s = suspect_grace_s
        cp.on_data_loss = self._recover_lost_data
        cp.on_orphan_tasks = self._recover_micro_tasks
        if self._recover_serving not in cp.on_pilot_dead:
            cp.on_pilot_dead.append(self._recover_serving)
        if start_interval_s is not None:
            cp.start(interval_s=start_interval_s)

    def _recover_lost_data(self, names: Sequence[str]) -> int:
        """ControlPlane hook: a dead pilot held the LAST replica of these
        datasets.  Re-run each distinct producing stage once (lineage
        recovery, HDFS-re-replication analogue)."""
        stages: List[str] = []
        for name in names:
            lin = self.dataplane.lineage_of(name)
            if lin is not None and lin.stage in self._stages \
                    and lin.stage not in stages:
                stages.append(lin.stage)
        recovered = 0
        for sname in stages:
            try:
                self._run_stage(self._stages[sname], (), 600.0)
                recovered += 1
            except BaseException as e:  # noqa: BLE001 — count what worked
                self.control_plane.errors.append(e)
        return recovered

    def _recover_micro_tasks(self, tasks: Sequence, survivors: List) -> int:
        """ControlPlane hook: a dead pilot's Raptor overlay orphaned
        these micro-tasks.  Resubmit each on a surviving overlay and
        mirror the new task's completion into the old handle (waiters
        hold the old one)."""
        try:
            master = self._overlay_for(None, None)
        except RuntimeError as e:
            for t in tasks:
                if not t.done:
                    t.error = e
                    t._finish()
            return 0
        resubmitted = 0
        for t in tasks:
            if t.done:
                continue
            try:
                fn, targs, tkwargs = t._load()
                nt = master.submit(fn, *targs, tenant=t.tenant,
                                   queue=t.queue, tag=t.tag,
                                   priority=t.priority,
                                   hbm_bytes=t.hbm_bytes, **tkwargs)
            except BaseException as e:  # noqa: BLE001
                t.error = e
                t._finish()
                continue

            def mirror(new, old=t):
                old.result = new.result
                old.error = new.error
                old._finish()

            nt.add_done_callback(mirror)
            resubmitted += 1
        return resubmitted

    def _recover_serving(self, pilot, survivors: List) -> int:
        """ControlPlane hook: move a dead decode pilot's in-flight serve
        requests onto surviving engines (router re-dispatch)."""
        moved = 0
        with self._lock:
            routers = list(self._routers)
        for r in routers:
            moved += r.recover_pilot(pilot.uid)
        return moved

    # ---------------------------------------------------- checkpoint/resume
    CHECKPOINT_VERSION = 1

    def checkpoint(self, path: Optional[str] = None) -> str:
        """Journal the session's DAG state to ``path`` (default: the
        ctor's checkpoint_dir): completed stage results, placements, and
        the DataPlane's named arrays with their lineage and home-pilot
        names.  Writes are tmp + atomic rename, so a crash mid-
        checkpoint leaves the previous one intact.  Virtual datasets
        (KV-page leases) are skipped — serve state is recovered live by
        the router, not from disk."""
        path = path or self.checkpoint_dir
        if path is None:
            raise ValueError("no checkpoint path (pass one or set "
                             "checkpoint_dir on the Session)")
        os.makedirs(path, exist_ok=True)
        with self._lock:
            results = dict(self.results)
            placements = {k: dict(v) for k, v in self.placements.items()}
        uid2name = {p.uid: name for name, p in self.pilots.items()}
        arrays: Dict[str, np.ndarray] = {}
        homes: Dict[str, List[str]] = {}
        lineage: Dict[str, Dict[str, Any]] = {}
        virtual_skipped = 0
        for name in self.dataplane.names():
            pd = self.dataplane.get(name)
            if pd is None:
                continue
            if pd.is_virtual:
                virtual_skipped += 1
                continue
            arrays[name] = convert.to_numpy(pd.array.full())
            # homes keyed by pilot NAME: uids are process-local counters
            homes[name] = sorted(
                uid2name.get(uid, uid) if uid != GFS_ARCHIVE else uid
                for uid in self.dataplane.home_pilots(name))
            lin = self.dataplane.lineage_of(name)
            if lin is not None:
                lineage[name] = {"stage": lin.stage,
                                 "inputs": list(lin.inputs)}

        def _atomic(fname: str, write: Callable[[Any], None],
                    mode: str = "wb") -> None:
            tmp = os.path.join(path, fname + ".tmp")
            with open(tmp, mode) as f:
                write(f)
            os.replace(tmp, os.path.join(path, fname))

        _atomic("data.npz", lambda f: np.savez(f, **arrays))
        # numpy and Python values only: a journal either package wrote
        # resumes in the other
        host_results = _to_host(results)
        _atomic("results.pkl", lambda f: pickle.dump(host_results, f))
        manifest = {"version": self.CHECKPOINT_VERSION, "t": time.time(),
                    "completed": sorted(results),
                    "placements": placements, "homes": homes,
                    "lineage": lineage, "datasets": sorted(arrays),
                    "virtual_skipped": virtual_skipped}
        _atomic("manifest.json",
                lambda f: json.dump(manifest, f, indent=1, default=str),
                mode="w")
        return path

    def _maybe_checkpoint(self) -> None:
        """Interval-gated journal write, called after each stage's
        results land; a failed write must not fail the stage."""
        if not self.checkpoint_dir or not self.checkpoint_interval_s:
            return
        with self._ckpt_lock:
            now = time.monotonic()
            if now - self._last_ckpt < self.checkpoint_interval_s:
                return
            self._last_ckpt = now
        try:
            self.checkpoint()
        except BaseException as e:  # noqa: BLE001
            self.control_plane.errors.append(e)

    @classmethod
    def resume(cls, path: str, rm: Optional[ResourceManager] = None,
               **kw) -> "Session":
        """Rebuild a Session from a checkpoint directory: completed
        stage results and placements load immediately; the DataPlane's
        arrays are restored lazily at the next :meth:`submit_dag` (they
        need pilots to land on — add_pilot first).  Stages listed as
        completed in the checkpoint are NOT re-run: submit_dag hands
        them pre-resolved futures."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("version") != cls.CHECKPOINT_VERSION:
            raise ValueError(
                f"checkpoint version {manifest.get('version')} != "
                f"{cls.CHECKPOINT_VERSION}")
        kw.setdefault("checkpoint_dir", path)
        self = cls(rm, **kw)
        with open(os.path.join(path, "results.pkl"), "rb") as f:
            self.results = pickle.load(f)
        self.placements = dict(manifest.get("placements", {}))
        self._restored_stages = set(manifest.get("completed", ()))
        self._restore_manifest = (path, manifest)
        return self

    def _restore_data(self) -> None:
        """Lazy half of :meth:`resume`: put every checkpointed array
        back on the DataPlane, homed on its original pilot when a pilot
        of that name was re-registered (else any pilot), with lineage
        reattached and the restore bytes ledgered as a GFS read."""
        if self._restore_manifest is None:
            return
        path, manifest = self._restore_manifest
        self._restore_manifest = None
        if not self.pilots:
            raise RuntimeError("resume: add_pilot before submitting a DAG "
                               "(restored data needs devices to land on)")
        data = np.load(os.path.join(path, "data.npz"))
        for name in manifest.get("datasets", ()):
            homes = manifest.get("homes", {}).get(name, [])
            pilot = next((self.pilots[h] for h in homes
                          if h in self.pilots
                          and self.pilots[h].state is PilotState.ACTIVE),
                         None)
            if pilot is None:
                pilot = next(p for p in self.pilots.values()
                             if p.state is PilotState.ACTIVE)
            arr = place(convert.to_tensor(_npz_array(data[name])),
                        replicated_sharding(pilot.devices))
            lin_d = manifest.get("lineage", {}).get(name)
            lin = (Lineage(stage=lin_d["stage"],
                           inputs=tuple(lin_d["inputs"]))
                   if lin_d else None)
            self.dataplane.put(name, arr, pilot=pilot.uid, lineage=lin)
            if GFS_ARCHIVE in homes:
                self.dataplane.add_replica(name, GFS_ARCHIVE)
            self.dataplane.record_moved(arr.nbytes, Link.GFS,
                                        reason="session-resume")
