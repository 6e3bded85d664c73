"""Pilot & PilotManager: placeholder allocations with an embedded Agent.

The paper's lifecycle (Fig 3): the Pilot-Manager submits a placeholder
job (steps P.1-P.2) whose Agent then pulls Compute-Units from the shared
queue (U.1-U.7). Here the placeholder job materializes as a device-slice
lease + Agent thread; pilot startup time (lease + agent boot + first
executor compile) is the Fig-5 'agent startup' measurement.

Elasticity: a pilot's slice is no longer frozen at creation.  The
PilotManager's :class:`ControlPlane` moves chips between pilots at
runtime — :meth:`Pilot.surrender_devices` is the drain-aware shrink
(scheduler stops new binds, running CUs finish or are preempted) and
:meth:`Pilot.absorb_devices` the live grow (queued gang CUs bind onto
the new slots mid-run).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from .agent import Agent
from .control_plane import ControlPlane
from .dataplane import DataPlane, DeviceGrid
from .resource_manager import ResourceManager

_pilot_counter = itertools.count()


class PilotState(enum.Enum):
    NEW = "new"
    PENDING = "pending"
    ACTIVE = "active"
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class PilotDescription:
    n_chips: int
    tp: int = 1                       # model-axis width of the pilot mesh
    name: str = "pilot"
    runtime: str = "hpc"              # 'hpc' | 'analytics' (Mode I vs II seed)
    reuse_app_master: bool = True
    app_master_overhead_s: float = 0.0
    n_spawners: Optional[int] = None  # executor threads (None: auto-size)
    enable_speculation: bool = True
    # advertised per-chip speeds (defaults: NVIDIA H100 SXM data sheet,
    # dense bf16 tensor-core FLOP/s and HBM3 bandwidth).  The Session
    # placer turns a stage's StageCost into a roofline est_runtime on
    # THIS pilot from these two numbers — heterogeneous pilots (HPC vs
    # analytics partitions) advertise different ones.
    peak_flops_per_chip: float = 989e12   # FLOP/s
    hbm_bw_per_chip: float = 3.35e12      # B/s
    scheduler_policy: Any = "fifo"    # 'fifo' | 'capacity' | 'drf' | instance
    queues: Optional[Sequence] = None  # QueueConfigs for the tenant queues
    # tiered staging pipeline (paper: data-staging to/from HDFS around
    # each Hadoop run; here: async tier promotion GFS->DCN->ICI)
    prefetch_workers: int = 2          # stage-in/out worker threads
    staging_delay_rounds: int = 8      # delay-scheduling hold (rounds)
    replica_cache_bytes: Optional[int] = None  # LRU budget (None: unbounded)


class Pilot:
    def __init__(self, desc: PilotDescription, rm: ResourceManager,
                 data_registry: Optional[DataPlane] = None):
        self.uid = f"pilot-{next(_pilot_counter):04d}"
        self.desc = desc
        self.rm = rm
        self.state = PilotState.NEW
        self.devices: List = []
        self.data = data_registry or DataPlane()
        self.agent: Optional[Agent] = None
        self.prefetcher = None         # staging pipeline, built in start()
        self.timings: Dict[str, float] = {"t_new": time.monotonic()}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- startup
    def start(self) -> "Pilot":
        self.state = PilotState.PENDING
        self.timings["t_pending"] = time.monotonic()
        self.devices = self.rm.grant(self.desc.n_chips, self.uid)
        self.agent = Agent(self, reuse_app_master=self.desc.reuse_app_master,
                           app_master_overhead_s=self.desc.app_master_overhead_s,
                           n_spawners=self.desc.n_spawners,
                           enable_speculation=self.desc.enable_speculation)
        # the prefetcher wakes the agent loop on every resolved transfer
        # so a delay-scheduled CU binds the round its inputs land
        from .staging import Prefetcher
        self.prefetcher = Prefetcher(
            self, self.data, n_workers=self.desc.prefetch_workers,
            cache_bytes=self.desc.replica_cache_bytes)
        self.prefetcher.notify = self.agent._wake.set
        self.agent.start()
        self.state = PilotState.ACTIVE
        self.timings["t_active"] = time.monotonic()
        return self

    def startup_s(self) -> float:
        return self.timings["t_active"] - self.timings["t_pending"]

    # -------------------------------------------------------------- meshes
    def mesh(self, devices: Optional[Sequence] = None, tp: Optional[int] = None,
             axis_names=("data", "model")) -> DeviceGrid:
        """(dp, tp) grid over `devices` (default: the whole slice).  A
        gang CU gets its own devices' grid as ``mesh=``;
        ``launch.spmd.run(grid, fn)`` runs `fn` once per device of it
        (one process per device) on the grid's ``DeviceMesh``."""
        devs = list(devices if devices is not None else self.devices)
        tp = tp or self.desc.tp
        tp = min(tp, len(devs))
        return DeviceGrid(devs, tp, axis_names)

    # ------------------------------------------------------------ submit
    def submit(self, cu_desc, **kw) -> Any:
        assert self.agent is not None, "pilot not started"
        return self.agent.submit(cu_desc, **kw)

    def stage_in(self, refs: Sequence, *, priority: int = 0,
                 reason: str = "stage-in") -> List:
        """Enqueue async tier promotion of ``refs`` (names or DataRefs)
        onto this pilot; returns the StageRequest futures.  Pass them to
        :meth:`submit` as ``staging=`` to delay-schedule a CU on them."""
        assert self.prefetcher is not None, "pilot not started"
        return self.prefetcher.request_many(refs, priority=priority,
                                            reason=reason)

    # ------------------------------------------------------------- overlay
    def spawn_raptor(self, n_workers: int, *,
                     tenant: Optional[str] = None,
                     queue: Optional[str] = None, **kw):
        """Start a Raptor micro-task overlay on this pilot: one
        long-running gang CU holding ``n_workers`` chips, whose
        persistent workers execute function-call-sized tasks with no
        per-task scheduler admission (see :mod:`repro_torch.core.raptor`).
        Blocks until the master CU is bound and its workers are live;
        stop with ``master.shutdown()``."""
        from .raptor import RaptorMaster
        assert self.agent is not None, "pilot not started"
        return RaptorMaster(self, n_workers, tenant=tenant, queue=queue,
                            **kw).start()

    # ------------------------------------------------------------ Mode I
    def spawn_analytics_cluster(self, n_chips: int, *,
                                tenant: Optional[str] = None,
                                queue: Optional[str] = None, **kw):
        """Carve an on-demand analytics cluster out of this pilot (Mode I,
        'Hadoop on HPC'). Chips come from the scheduler's public
        ``carve_out`` API (HBM accounted, charged to the tenant's queue
        under its ACL/caps) and are restored on
        ``AnalyticsCluster.shutdown()``."""
        from .modes import AnalyticsCluster
        assert self.agent is not None
        idxs = self.agent.reserve_chips(n_chips, tenant=tenant, queue=queue)
        devs = self.agent.scheduler.devices_of(idxs)
        cluster = AnalyticsCluster(devs, parent=self, reserved_idxs=idxs, **kw)
        return cluster

    # ----------------------------------------------------------- elasticity
    def absorb_devices(self, devices: Sequence) -> None:
        """Live grow: the ControlPlane granted us chips — extend the
        slice and hand the slots to the scheduler (queued gang CUs can
        bind on them mid-run)."""
        assert self.agent is not None
        if not devices:
            return
        with self._lock:
            self.devices.extend(devices)
        self.agent.scheduler.add_devices(devices)
        self.agent._wake.set()

    def forget_devices(self, devices: Sequence) -> None:
        """Drop drained devices from the slice (count-aware: dry-run
        slices may alias one physical device many times)."""
        with self._lock:
            for d in devices:
                if d in self.devices:
                    self.devices.remove(d)

    def surrender_devices(self, n: int, *, preempt_after_s: float = 0.5,
                          timeout: float = 30.0) -> List:
        """Drain-aware shrink: pick n chips (idle first), stop new binds,
        wait for or preempt the CUs on them, and return the freed device
        objects.  The lease is still held — the caller walks it through
        ``rm.reclaim`` (the ControlPlane does this in :meth:`~repro_torch.core.
        control_plane.ControlPlane.move`)."""
        assert self.agent is not None
        idxs = self.agent.scheduler.pick_drain_candidates(n)
        if not idxs:
            return []
        devs = self.agent.service_drain(idxs, preempt_after_s=preempt_after_s,
                                        timeout=timeout)
        self.forget_devices(devs)
        return devs

    def fail_device(self, device) -> List[str]:
        """Simulate a node failure: removes the device, returns impacted CUs
        (which the agent re-queues per their retry policy)."""
        assert self.agent is not None
        self.rm.mark_failed(device)
        with self._lock:
            if device in self.devices:
                self.devices.remove(device)
        return self.agent.handle_device_loss([device])

    def resize(self, n_chips: int) -> None:
        """Elastic grow/shrink to n_chips through the grant/reclaim
        lease lifecycle."""
        assert self.agent is not None
        cur = len(self.devices)
        if n_chips > cur:
            self.absorb_devices(self.rm.grant(n_chips - cur, self.uid))
        elif n_chips < cur:
            drop = self.surrender_devices(cur - n_chips)
            if drop:
                self.rm.reclaim(self.uid, drop)

    def kill(self) -> None:
        """Chaos: the whole pilot vanishes (node failure / walltime
        expiry).  Unlike :meth:`shutdown` nothing drains and nothing is
        released — the agent just crashes and the staging pipeline
        stops.  The state deliberately stays ACTIVE: the cluster only
        learns of the death when the ControlPlane's heartbeat deadline
        expires (``check_failures`` → ``recover_pilot``), which then
        marks the pilot FAILED and reclaims the lease."""
        if self.prefetcher is not None:
            self.prefetcher.stop()
        if self.agent is not None:
            self.agent.kill()
        self.timings["t_killed"] = time.monotonic()

    def mark_failed(self) -> None:
        """Recovery epitaph: the ControlPlane declared this pilot DEAD.
        From here on the pilot is out of every candidate set (placer,
        rebalancer, injector)."""
        self.state = PilotState.FAILED
        self.timings["t_failed"] = time.monotonic()

    def shutdown(self) -> None:
        if self.prefetcher is not None:
            self.prefetcher.stop()
        if self.agent is not None:
            self.agent.stop()
        self.rm.release(self.uid)
        self.state = PilotState.DONE
        self.timings["t_done"] = time.monotonic()


class PilotManager:
    """Client-side manager for a set of Pilots (paper: Pilot-Manager).
    Owns the :class:`ControlPlane` that rebalances chips across them."""

    def __init__(self, rm: Optional[ResourceManager] = None, **cp_kwargs):
        self.rm = rm or ResourceManager()
        self.pilots: List[Pilot] = []
        self.control_plane = ControlPlane(self, **cp_kwargs)

    def submit(self, desc: PilotDescription,
               data_registry: Optional[DataPlane] = None) -> Pilot:
        pilot = Pilot(desc, self.rm, data_registry)
        pilot.start()
        self.pilots.append(pilot)
        return pilot

    def shutdown(self) -> None:
        self.control_plane.stop()
        for p in self.pilots:
            if p.state is PilotState.ACTIVE:
                p.shutdown()
