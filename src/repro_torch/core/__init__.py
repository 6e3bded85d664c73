"""Pilot-Abstraction core, ported to PyTorch (mirrors ``repro.core``).

Each Pilot acquires a device slice from the ``ResourceManager`` (system
level); its ``Agent`` then multiplexes ``ComputeUnit``s onto that slice
through a YARN-style slot scheduler — with data locality, gang
scheduling, two-phase admission with AppMaster reuse, straggler
speculation and elastic resize — over the shared ``DataPlane``.

Ported so far: everything the Pilot → Agent → Mode-I analytics cluster
path imports.  The Session, Raptor overlays and failure injection are
not ported yet.
"""
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
from .resource_manager import ResourceManager  # noqa: F401
from .scheduler import YarnStyleScheduler  # noqa: F401
from .staging import (DataRef, Prefetcher, ReplicaCache,  # noqa: F401
                      StageRequest, StageState)
from .unit_manager import UnitManager  # noqa: F401
from . import modes  # noqa: F401
