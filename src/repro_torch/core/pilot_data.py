"""Pilot-Data compatibility shim.

The single-pilot ``PilotDataRegistry`` grew into the cross-pilot
:class:`~repro_torch.core.dataplane.DataPlane` (placement + replica tracking
per pilot, transfer-cost model, lineage, public moved-bytes ledger).
This module keeps the original import path alive; new code should
import from ``repro_torch.core.dataplane`` directly.
"""
from .dataplane import (  # noqa: F401
    DataPlane,
    Lineage,
    Link,
    PilotData,
    PilotDataRegistry,
    TransferCostModel,
)
