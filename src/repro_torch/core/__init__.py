"""Pilot-Abstraction core, ported to PyTorch (mirrors ``repro.core``).

Multi-level scheduling: a ``Session`` (application level) places whole
stages across heterogeneous ``Pilot``s by trading data locality against
modeled movement cost over the shared ``DataPlane``; each Pilot acquires
a device slice from the ``ResourceManager`` (system level); its
``Agent`` then multiplexes ``ComputeUnit``s onto that slice through a
YARN-style slot scheduler — with data locality, gang scheduling,
two-phase admission with AppMaster reuse, straggler speculation and
elastic resize.  Raptor overlays run micro-tasks inside a pilot without
per-task admission, and the ``FailureInjector`` kills chips, agents and
pilots so that recovery can be measured.  ``Session.serve_pool`` builds
the serving stack (:mod:`repro_torch.serve`) on the Session's pilots;
it imports it when called, so importing the core loads no model code.
"""
from .chaos import FailureInjector, KillEvent  # noqa: F401
from .compute_unit import ComputeUnit, ComputeUnitDescription, CUState  # noqa: F401
from .control_plane import (ControlPlane, FailureEvent,  # noqa: F401
                            RebalanceEvent)
from .dataplane import (DataPlane, DeviceGrid, GFS_ARCHIVE,  # noqa: F401
                        Lineage, Link, PilotData, PilotDataRegistry,
                        Placement, ShardedTensor, TransferCostModel, place,
                        replicated_sharding)
from .pilot import Pilot, PilotDescription, PilotManager, PilotState  # noqa: F401
from .queues import (CapacityPolicy, DrfPolicy, FifoPolicy,  # noqa: F401
                     QueueConfig, QueueTree, SchedulingPolicy, make_policy)
from .raptor import MicroTask, RaptorMaster  # noqa: F401
from .resource_manager import ResourceManager  # noqa: F401
from .scheduler import YarnStyleScheduler  # noqa: F401
from .session import (Session, Stage, StageCost, TenantContext,  # noqa: F401
                      analytics_stage, hpc_stage)
from .staging import (DataRef, Prefetcher, ReplicaCache,  # noqa: F401
                      StageRequest, StageState)
from .unit_manager import UnitManager  # noqa: F401
from . import modes  # noqa: F401
