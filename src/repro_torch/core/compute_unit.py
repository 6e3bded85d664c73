"""Compute-Units: the self-contained pieces of work submitted to a Pilot.

A CU is the paper's unit of workload: an executable plus resource
requirements plus data dependencies. Here the executable is a Python
callable invoked with the CU's assigned device grid (``mesh``, a
:class:`~repro_torch.core.dataplane.DeviceGrid`); ``gang=True``
requests all chips atomically (MPI-like HPC stages), ``gang=False``
lets the scheduler bin-pack (Hadoop-like fine-grained tasks).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

_cu_counter = itertools.count()


class CUState(enum.Enum):
    NEW = "new"
    PENDING = "pending"            # queued at the scheduler
    RESERVED = "reserved"          # phase-1: AppMaster slot granted
    RUNNING = "running"            # phase-2: containers bound, executing
    DONE = "done"
    FAILED = "failed"
    CANCELED = "canceled"


@dataclasses.dataclass
class ComputeUnitDescription:
    fn: Callable[..., Any]
    args: Tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    n_chips: int = 1
    memory_bytes: int = 0              # HBM slot request (YARN-style memory)
    gang: bool = False                 # all chips atomically (HPC stage)
    data: Sequence[str] = ()           # PilotData names this CU reads
    tag: str = "cu"                    # workload class (straggler stats key)
    priority: int = 0
    max_retries: int = 0
    app_id: Optional[str] = None       # CUs sharing an app reuse the AppMaster
    needs_mesh: bool = True            # pass the assigned sub-mesh as kwarg
    tenant: Optional[str] = None       # submitting tenant (queue ACL subject)
    queue: Optional[str] = None        # tenant queue (default: tenant name)
    # declarative staging directives (RADICAL-Pilot's per-task
    # stage_in/stage_out): DataRefs (or plain names) the prefetcher
    # promotes onto this CU's pilot before it runs / spools out after.
    # The scheduler delay-schedules a CU whose stage_in is in flight.
    stage_in: Sequence[Any] = ()
    stage_out: Sequence[Any] = ()
    # placer's roofline runtime estimate (seconds) for this CU on the
    # pilot it was submitted to — the straggler watchdog's baseline
    # when the tag has no EMA history yet (speculate on actual > k×est)
    est_runtime_s: Optional[float] = None


class ComputeUnit:
    def __init__(self, desc: ComputeUnitDescription):
        self.uid = f"cu-{next(_cu_counter):05d}"
        self.desc = desc
        self.state = CUState.NEW
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.assigned_devices: Sequence = ()
        self.retries = 0
        self.speculative_of: Optional[str] = None
        self.timings: Dict[str, float] = {}
        # in-flight stage-in transfers (StageRequest futures) this CU
        # waits on — the scheduler holds the CU (bounded delay
        # scheduling) until they resolve or the delay budget expires
        self.staging_futures: Sequence[Any] = ()
        self._done = threading.Event()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- states
    def _set_state(self, state: CUState) -> None:
        with self._lock:
            self.state = state
            self.timings[f"t_{state.value}"] = time.monotonic()
            if state in (CUState.DONE, CUState.FAILED, CUState.CANCELED):
                self._done.set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"{self.uid} not done after {timeout}s")
        if self.state is CUState.FAILED:
            raise RuntimeError(f"{self.uid} failed: {self.error}") from self.error
        return self.result

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def staging_ready(self) -> bool:
        """True when no stage-in transfer is still in flight (resolved,
        failed, or converted to a remote read) — the scheduler's
        delay-scheduling predicate."""
        return all(r.done for r in self.staging_futures)

    def follow(self, timeout: Optional[float] = None) -> Any:
        """Like :meth:`wait`, but follows re-queue clones: preemption,
        drain and device-loss replace a canceled CU with a clone and
        leave it in ``result`` — callers that just want the final value
        chase the chain to its end."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        cu: "ComputeUnit" = self
        while True:
            left = (None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
            out = cu.wait(left)
            if isinstance(out, ComputeUnit):
                cu = out
                continue
            return out

    # ------------------------------------------------------- measurements
    def overhead_s(self) -> Optional[float]:
        """Submission -> execution-start latency (the paper's Fig-5 inset)."""
        t0 = self.timings.get("t_pending")
        t1 = self.timings.get("t_running")
        return None if t0 is None or t1 is None else t1 - t0

    def runtime_s(self) -> Optional[float]:
        t0 = self.timings.get("t_running")
        t1 = (self.timings.get("t_done") or self.timings.get("t_failed")
              or self.timings.get("t_canceled"))
        return None if t0 is None or t1 is None else t1 - t0
