"""Mode I and Mode II: the paper's two usage modes (Fig 1).

Mode I  (Hadoop on HPC): ``pilot.spawn_analytics_cluster(n)`` carves an
on-demand analytics cluster out of an HPC pilot's allocation — the
analogue of the LRM downloading/configuring/starting YARN or Spark on
the allocated nodes. Cluster startup is measurable (Fig-5 analogue) and
chips return to the pilot on shutdown.

Mode II (HPC on Hadoop): an ``AnalyticsCluster`` owns the allocation
(Wrangler's dedicated Hadoop environment); ``run_hpc`` gang-schedules an
HPC-stage callable onto the cluster's mesh — the gang semantics YARN
lacked, provided by our scheduler.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.compute_unit import ComputeUnitDescription
from repro_torch.core.dataplane import DataPlane, DeviceGrid


class AnalyticsCluster:
    """An analytics runtime bound to a device set (Spark-standalone-like)."""

    def __init__(self, devices: Sequence, *, parent=None,
                 reserved_idxs: Sequence[int] = (), tp: int = 1,
                 data: Optional[DataPlane] = None):
        t0 = time.monotonic()
        self.devices = list(devices)
        self.parent = parent
        self._reserved_idxs = list(reserved_idxs)
        # 'cluster spawn' = build the device grid + engine (paper: write
        # configs, start NameNode/ResourceManager daemons)
        self.mesh = DeviceGrid(self.devices, tp)
        from repro_torch.analytics.engine import AnalyticsEngine
        self.engine = AnalyticsEngine(
            self.mesh, data or (parent.data if parent is not None else None))
        self.startup_s = time.monotonic() - t0
        self._shutdown = False

    # ----------------------------------------------------------- Mode II
    def run_hpc(self, fn: Callable, *args, pilot=None,
                tenant: Optional[str] = None, queue: Optional[str] = None,
                **kwargs) -> Any:
        """Gang-schedule an HPC callable on this cluster's devices.

        If a pilot is given, goes through its scheduler as a gang CU
        (paper: RADICAL-Pilot-Agent connecting to a running YARN
        cluster); otherwise executes directly under the cluster's device grid.
        ``tenant``/``queue`` tag the CU — required when the pilot
        declares tenant queues (strict routing rejects untagged work).
        """
        if pilot is not None:
            cu = pilot.submit(ComputeUnitDescription(
                fn=fn, args=args, kwargs=kwargs, n_chips=len(self.devices),
                gang=True, tag="hpc-on-analytics",
                tenant=tenant, queue=queue))
            return cu.wait(300)
        return fn(*args, mesh=self.mesh, **kwargs)

    def shutdown(self) -> None:
        """Stop daemons and return chips to the parent pilot (Mode I)."""
        if self._shutdown:
            return
        self._shutdown = True
        if self.parent is not None and self.parent.agent is not None:
            self.parent.agent.return_chips(self._reserved_idxs)
