"""Unit-Manager: client-side workload manager (paper Fig 3, steps U.1-U.2).

Queues Compute-Units to one or more Pilots with a pluggable distribution
policy (round-robin / locality-greedy across pilots). The shared-queue
role MongoDB plays in RADICAL-Pilot is played by the in-process
scheduler queues.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .compute_unit import ComputeUnit, ComputeUnitDescription
from .pilot import Pilot


class UnitManager:
    def __init__(self, pilots: Sequence[Pilot] | Pilot):
        self.pilots: List[Pilot] = ([pilots] if isinstance(pilots, Pilot)
                                    else list(pilots))
        self._rr = 0

    def add_pilot(self, pilot: Pilot) -> None:
        self.pilots.append(pilot)

    def _pick(self, desc: ComputeUnitDescription) -> Pilot:
        if desc.data:
            best, score = None, -1.0
            for p in self.pilots:
                s = p.data.locality_score(desc.data, p.devices)
                if s > score:
                    best, score = p, s
            if best is not None:
                return best
        p = self.pilots[self._rr % len(self.pilots)]
        self._rr += 1
        return p

    def submit(self, desc: ComputeUnitDescription,
               pilot: Optional[Pilot] = None) -> ComputeUnit:
        return (pilot or self._pick(desc)).submit(desc)

    def submit_many(self, descs: Sequence[ComputeUnitDescription]
                    ) -> List[ComputeUnit]:
        return [self.submit(d) for d in descs]

    def wait_all(self, cus: Sequence[ComputeUnit], timeout: float = 300.0):
        return [cu.wait(timeout) for cu in cus]
