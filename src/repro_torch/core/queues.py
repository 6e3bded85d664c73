"""Hierarchical multi-tenant queues + pluggable scheduling policies.

The paper's YARN layer exists so many concurrent applications can share
one allocation; a single priority-sorted list cannot express that — one
tenant's flood starves every other tenant.  This module is the missing
cross-tenant layer, modeled on YARN's Capacity/Fair schedulers:

  * :class:`QueueConfig` / :class:`TenantQueue` / :class:`QueueTree` —
    named tenant queues with guaranteed and maximum (chips, HBM-bytes)
    shares, weights, and optional submit ACLs (YARN queue ACLs);
  * :class:`SchedulingPolicy` — the pluggable inter-queue arbitration
    interface the :class:`~repro_torch.core.scheduler.YarnStyleScheduler`
    consults on every scheduling round:

      - :class:`FifoPolicy` (default) — one global (-priority, arrival)
        order across all queues; byte-for-byte the pre-queue behavior;
      - :class:`CapacityPolicy` — YARN CapacityScheduler: most-starved
        guaranteed queue first, elastic borrowing above the guarantee up
        to the queue's max, and reclaim-via-preemption when a guaranteed
        queue is starved by a borrower;
      - :class:`DrfPolicy` — Dominant Resource Fairness (the YARN
        FairScheduler's drf mode) over the 2-D (chips, HBM) vector:
        the queue with the smallest weighted dominant share picks next.

Queues order their own pending CUs by a stable ``(-priority, seq)`` key
maintained with ``bisect.insort`` — O(log n) per submit instead of the
former full re-sort — and ``seq`` is global across queues so the FIFO
merge reproduces exact arrival order.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import (Dict, FrozenSet, List, Optional, Sequence,
                    Tuple, Union)

from .compute_unit import ComputeUnit

DEFAULT_QUEUE = "default"

#: one pending entry: ((-priority, seq), cu) — tuple order IS schedule
#: order within a queue, and seq is unique so the CU is never compared.
Entry = Tuple[Tuple[int, int], ComputeUnit]


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    """Declared share of one tenant queue (YARN capacity-scheduler.xml).

    ``guaranteed_*`` is the floor the queue can always reclaim (0 = best
    effort); ``max_*`` caps elastic borrowing (None = may borrow the
    whole pilot); ``weight`` scales the DRF dominant share; ``acl``
    restricts which tenants may submit (None = open, YARN's ``*``).
    """
    name: str
    guaranteed_chips: int = 0
    guaranteed_hbm: int = 0
    max_chips: Optional[int] = None
    max_hbm: Optional[int] = None
    weight: float = 1.0
    acl: Optional[FrozenSet[str]] = None

    def allows(self, tenant: Optional[str]) -> bool:
        if self.acl is None:
            return True
        return tenant is not None and tenant in self.acl


class TenantQueue:
    """One named queue: sorted pending entries + live usage accounting."""

    def __init__(self, config: QueueConfig):
        self.config = config
        self.pending: List[Entry] = []
        self.chips_used = 0
        self.hbm_used = 0
        # Raptor micro-tasks: chips lent by an overlay worker count in
        # chips_used (so caps/DRF see them) and are itemized here
        self.micro_running = 0        # gauge: micro-tasks on chips now
        self.micro_done = 0           # cumulative completed micro-tasks

    @property
    def name(self) -> str:
        return self.config.name

    def push(self, cu: ComputeUnit, seq: int) -> None:
        bisect.insort(self.pending, ((-cu.desc.priority, seq), cu))

    def remove(self, entry: Entry) -> None:
        i = bisect.bisect_left(self.pending, entry[0],
                               key=lambda e: e[0])
        if i < len(self.pending) and self.pending[i][0] == entry[0]:
            del self.pending[i]            # seq is unique: key finds it

    def queued_chip_demand(self) -> int:
        return sum(cu.desc.n_chips for _, cu in self.pending if not cu.done)

    def queue_len(self) -> int:
        return sum(1 for _, cu in self.pending if not cu.done)

    def snapshot(self) -> Dict[str, int]:
        return {
            "queue_len": self.queue_len(),
            "queued_chip_demand": self.queued_chip_demand(),
            "chips_used": self.chips_used,
            "hbm_used": self.hbm_used,
            "guaranteed_chips": self.config.guaranteed_chips,
            "micro_running": self.micro_running,
            "micro_done": self.micro_done,
        }


class QueueTree:
    """The scheduler's queue table: routes CUs to tenant queues, tracks
    per-queue (chips, HBM) usage, and answers guarantee questions.

    Unknown queue names auto-create a best-effort queue (guarantee 0, no
    cap) so single-tenant callers need no configuration at all.
    """

    def __init__(self, configs: Optional[Sequence[QueueConfig]] = None,
                 *, hbm_per_chip: int = 0):
        self.queues: Dict[str, TenantQueue] = {}
        self.hbm_per_chip = hbm_per_chip
        # explicit configs switch routing to strict mode: shares/ACLs
        # cannot be escaped by submitting to a made-up queue name
        self.declared = bool(configs)
        self._seq = itertools.count()
        for cfg in configs or ():
            if cfg.name in self.queues:
                raise ValueError(f"queue {cfg.name!r} declared twice")
            self.queues[cfg.name] = TenantQueue(cfg)
        self._default_declared = DEFAULT_QUEUE in self.queues
        if not self._default_declared:
            self.queues[DEFAULT_QUEUE] = TenantQueue(QueueConfig(DEFAULT_QUEUE))

    # ------------------------------------------------------------- routing
    def admission_queue(self, queue_name: Optional[str],
                        tenant: Optional[str]) -> TenantQueue:
        """Queue for a (queue, tenant) pair — queue name, else tenant
        name, else default — enforcing the target queue's submit ACL.
        Unknown names auto-create a best-effort queue ONLY while no
        queue was explicitly declared — with declared queues, an
        undefined name (or untagged work, which would land in the
        uncapped implicit default) is rejected YARN-style so caps and
        ACLs cannot be side-stepped."""
        name = queue_name or tenant or DEFAULT_QUEUE
        q = self.queues.get(name)
        if self.declared and name == DEFAULT_QUEUE \
                and not self._default_declared:
            raise ValueError(
                "untagged CU on a pilot with declared queues: the "
                "implicit 'default' queue has no caps or ACL, so it "
                "would escape the declared shares — declare "
                "QueueConfig('default', ...) to accept untagged work")
        if q is None:
            if self.declared:
                raise ValueError(
                    f"unknown queue {name!r}: this pilot declares "
                    f"{sorted(self.queues)} — submitting to an undefined "
                    "queue would escape the declared shares/ACLs")
            q = self.queues[name] = TenantQueue(QueueConfig(name))
        if not q.config.allows(tenant):
            raise PermissionError(
                f"tenant {tenant!r} may not submit to queue "
                f"{name!r} (acl={sorted(q.config.acl or ())})")
        return q

    def route(self, cu: ComputeUnit) -> TenantQueue:
        return self.admission_queue(cu.desc.queue, cu.desc.tenant)

    def submit(self, cu: ComputeUnit) -> TenantQueue:
        q = self.route(cu)
        q.push(cu, next(self._seq))
        return q

    def get(self, name: str) -> Optional[TenantQueue]:
        return self.queues.get(name)

    def all(self) -> List[TenantQueue]:
        return list(self.queues.values())

    # ---------------------------------------------------------- accounting
    def charge(self, name: str, chips: int, hbm: int) -> None:
        q = self.queues.get(name)
        if q is not None:
            q.chips_used += chips
            q.hbm_used += hbm

    def uncharge(self, name: str, chips: int, hbm: int) -> None:
        q = self.queues.get(name)
        if q is not None:
            q.chips_used = max(q.chips_used - chips, 0)
            q.hbm_used = max(q.hbm_used - hbm, 0)

    def micro_start(self, name: str, hbm: int) -> None:
        """A Raptor worker starts a micro-task for this queue: one chip
        (the worker's) plus the task's HBM counts as the queue's usage —
        DRF dominant shares and Capacity/max caps see micro-task load
        exactly like CU load."""
        q = self.queues.get(name)
        if q is not None:
            q.chips_used += 1
            q.hbm_used += hbm
            q.micro_running += 1

    def micro_finish(self, name: str, hbm: int) -> None:
        q = self.queues.get(name)
        if q is not None:
            q.chips_used = max(q.chips_used - 1, 0)
            q.hbm_used = max(q.hbm_used - hbm, 0)
            q.micro_running = max(q.micro_running - 1, 0)
            q.micro_done += 1

    # ------------------------------------------------------------- queries
    def pending_entries(self) -> List[Tuple[Entry, TenantQueue]]:
        """All pending entries in global (-priority, arrival) order."""
        merged = heapq.merge(
            *([(e, q) for e in q.pending] for q in self.queues.values()),
            key=lambda pair: pair[0][0])
        return list(merged)

    def has_pending_uid(self, uid: str) -> bool:
        return any(cu.uid == uid
                   for q in self.queues.values() for _, cu in q.pending)

    def guaranteed_chips_of(self, q: TenantQueue) -> int:
        """A queue's guarantee in chips: ``guaranteed_chips``, raised by
        ``guaranteed_hbm`` expressed in whole chips — HBM travels with
        chips, so the HBM guarantee is enforced through every
        chip-denominated path (floors, reclaim, preemption)."""
        g = q.config.guaranteed_chips
        if q.config.guaranteed_hbm > 0 and self.hbm_per_chip > 0:
            g = max(g, -(q.config.guaranteed_hbm // -self.hbm_per_chip))
        return g

    def guarantee_floor(self) -> int:
        """Chips the pilot must keep to honor demand-backed guarantees:
        per queue, min(guarantee, current usage + queued demand) — an
        idle guaranteed queue does not pin chips."""
        floor = 0
        for q in self.queues.values():
            g = self.guaranteed_chips_of(q)
            if g <= 0:
                continue
            floor += min(g, q.chips_used + q.queued_chip_demand())
        return floor

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {name: q.snapshot() for name, q in self.queues.items()
                if q.pending or q.chips_used or q.hbm_used
                or self.guaranteed_chips_of(q)
                or name == DEFAULT_QUEUE}


# --------------------------------------------------------------- policies
class SchedulingPolicy:
    """Inter-queue arbitration consulted by the scheduler each round."""

    name = "base"

    def pick_queue(self, tree: QueueTree,
                   heads: Dict[str, Tuple[int, int]],
                   totals: Tuple[int, int]) -> str:
        """Choose the next queue to offer a slot to.  ``heads`` maps each
        queue with remaining candidates to its head entry key;
        ``totals`` is the pilot's live (chips, HBM) capacity."""
        raise NotImplementedError

    def may_admit(self, tree: QueueTree, q: TenantQueue,
                  cu: ComputeUnit, hbm_request: int) -> bool:
        """Capacity caps: a queue at its max share stops borrowing."""
        cfg = q.config
        if cfg.max_chips is not None \
                and q.chips_used + cu.desc.n_chips > cfg.max_chips:
            return False
        if cfg.max_hbm is not None and q.hbm_used + hbm_request > cfg.max_hbm:
            return False
        return True

    def victim_floor(self, tree: QueueTree, queue_name: str) -> int:
        """Chips a victim's queue may not be preempted below (0 = any)."""
        return 0

    def reclaims(self) -> bool:
        """Whether starved guaranteed queues reclaim via preemption."""
        return False


class FifoPolicy(SchedulingPolicy):
    """Global (-priority, arrival) order across all queues — exactly the
    single sorted list the scheduler used before queues existed."""

    name = "fifo"

    def pick_queue(self, tree, heads, totals):
        return min(heads, key=lambda name: (heads[name], name))


class CapacityPolicy(SchedulingPolicy):
    """YARN CapacityScheduler: most-starved guaranteed queue first (by
    used/guarantee ratio), then best-effort queues by absolute usage;
    borrowing above the guarantee is elastic up to ``max_*``; a starved
    guaranteed queue reclaims borrowed chips via preemption."""

    name = "capacity"

    @staticmethod
    def _ratio(tree: QueueTree, q: TenantQueue) -> float:
        g = tree.guaranteed_chips_of(q)
        if g > 0:
            return q.chips_used / g
        return 1.0 + q.chips_used          # best-effort: after guaranteed

    def pick_queue(self, tree, heads, totals):
        return min(heads, key=lambda name: (
            self._ratio(tree, tree.queues[name]), heads[name], name))

    def victim_floor(self, tree, queue_name):
        q = tree.get(queue_name)
        return tree.guaranteed_chips_of(q) if q is not None else 0

    def reclaims(self):
        return True


class DrfPolicy(SchedulingPolicy):
    """Dominant Resource Fairness over (chips, HBM-bytes): each queue's
    dominant share is max(chips_used/total_chips, hbm_used/total_hbm)
    divided by its weight; the smallest dominant share schedules next
    (Ghodsi et al., NSDI'11 — YARN FairScheduler drf mode)."""

    name = "drf"

    @staticmethod
    def dominant_share(q: TenantQueue, totals: Tuple[int, int]) -> float:
        chips_total, hbm_total = max(totals[0], 1), max(totals[1], 1)
        share = max(q.chips_used / chips_total, q.hbm_used / hbm_total)
        return share / max(q.config.weight, 1e-9)

    def pick_queue(self, tree, heads, totals):
        return min(heads, key=lambda name: (
            self.dominant_share(tree.queues[name], totals),
            heads[name], name))


_POLICIES = {p.name: p for p in (FifoPolicy, CapacityPolicy, DrfPolicy)}


def make_policy(spec: Union[str, SchedulingPolicy, None]) -> SchedulingPolicy:
    if spec is None:
        return FifoPolicy()
    if isinstance(spec, SchedulingPolicy):
        return spec
    cls = _POLICIES.get(spec)
    if cls is None:
        raise ValueError(f"unknown scheduling policy {spec!r} "
                         f"(have {sorted(_POLICIES)})")
    return cls()
