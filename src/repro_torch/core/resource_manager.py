"""System-level resource manager (the SLURM/PBS analogue).

Owns the global device pool and leases slices to Pilots through an
explicit grant/reclaim lifecycle: :meth:`grant` moves free devices into
a pilot's lease, :meth:`reclaim` takes specific devices back (ownership
checked) — the primitive the ControlPlane composes into cross-pilot
rebalances (drain cold pilot → reclaim → grant to hot pilot).  Every
transition is appended to :attr:`lease_events` so "who held what, when"
is answerable after the fact.

With no ``devices`` argument the pool is every visible CUDA device; with
no CUDA that raises.  The CPU is used only when the caller passes it
(``devices=[torch.device("cpu")] * n`` aliases one device across n
lease slots).  Devices are matched by identity, so the pool's own
device objects are what every placement downstream carries.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

# H100 SXM: 80 GB of HBM3 (NVIDIA H100 Tensor Core GPU data sheet).  Used
# for pools that are not CUDA devices; a CUDA pool reads its own size.
HBM_BYTES_PER_CHIP = 80 * 1024**3


def cuda_pool() -> List[torch.device]:
    """One ``torch.device`` per visible CUDA device; raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: pass devices= explicitly "
            "(e.g. [torch.device('cpu')] * n) to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def hbm_bytes_of(devices: Sequence) -> int:
    """Per-chip HBM of a pool: the smallest CUDA card's total memory, or
    :data:`HBM_BYTES_PER_CHIP` for a pool without CUDA devices."""
    sizes = [torch.cuda.get_device_properties(d).total_memory
             for d in devices if getattr(d, "type", None) == "cuda"]
    return min(sizes) if sizes else HBM_BYTES_PER_CHIP


class ResourceManager:
    def __init__(self, devices: Optional[Sequence] = None,
                 hbm_per_chip: Optional[int] = None):
        self._devices = list(devices if devices is not None else cuda_pool())
        self._leased: Dict[int, str] = {}  # device index -> pilot id
        self._failed: set[int] = set()
        self._lock = threading.Lock()
        self.hbm_per_chip = (hbm_per_chip if hbm_per_chip is not None
                             else hbm_bytes_of(self._devices))
        self.lease_events: List[Dict[str, Any]] = []
        self.stats = {"granted": 0, "reclaimed": 0}

    @property
    def n_devices(self) -> int:
        return len(self._devices)

    def free_indices(self) -> List[int]:
        with self._lock:
            return [i for i in range(len(self._devices))
                    if i not in self._leased and i not in self._failed]

    def holdings(self, pilot_id: str) -> List[int]:
        """Device indices currently leased to `pilot_id`."""
        with self._lock:
            return sorted(i for i, p in self._leased.items() if p == pilot_id)

    def _log(self, kind: str, pilot_id: Optional[str],
             idxs: Sequence[int]) -> None:
        self.lease_events.append({"t": time.monotonic(), "event": kind,
                                  "pilot": pilot_id, "indices": list(idxs)})

    # ------------------------------------------------------ grant / reclaim
    def grant(self, n: int, pilot_id: str) -> List:
        """Grant n free devices to a pilot's lease (contiguous-first,
        like a rack-aware RM). Raises if the pool cannot cover it."""
        with self._lock:
            free = [i for i in range(len(self._devices))
                    if i not in self._leased and i not in self._failed]
            if len(free) < n:
                raise RuntimeError(
                    f"insufficient devices: want {n}, free {len(free)}")
            take = free[:n]
            for i in take:
                self._leased[i] = pilot_id
            self.stats["granted"] += n
            self._log("grant", pilot_id, take)
            return [self._devices[i] for i in take]

    def lease(self, n: int, pilot_id: str) -> List:
        """Back-compat alias for :meth:`grant`."""
        return self.grant(n, pilot_id)

    def reclaim(self, pilot_id: Optional[str], devices: Sequence) -> List[int]:
        """Take specific devices back from a pilot's lease.  When
        `pilot_id` is given, ownership is verified — reclaiming a device
        the pilot does not hold raises. Returns the reclaimed indices.

        Dry-run pools repeat one device object across many lease slots,
        so each handed-back device releases ONE matching leased index
        (the pilot's own when `pilot_id` is given)."""
        with self._lock:
            taken: List[int] = []
            for d in devices:
                i = next((i for i, dev in enumerate(self._devices)
                          if i not in taken and id(dev) == id(d)
                          and self._leased.get(i) is not None
                          and (pilot_id is None
                               or self._leased[i] == pilot_id)), None)
                if i is None:
                    if pilot_id is not None:
                        raise ValueError(
                            f"{pilot_id!r} holds no lease on {d!r}")
                    continue
                del self._leased[i]
                taken.append(i)
            if taken:
                self.stats["reclaimed"] += len(taken)
                self._log("reclaim", pilot_id, taken)
            return taken

    # ------------------------------------------------------------- release
    def release(self, pilot_id: str) -> None:
        """Drop a pilot's entire lease (pilot shutdown)."""
        with self._lock:
            gone = [i for i, p in self._leased.items() if p == pilot_id]
            self._leased = {i: p for i, p in self._leased.items()
                            if p != pilot_id}
            if gone:
                self.stats["reclaimed"] += len(gone)
                self._log("release", pilot_id, gone)

    def release_devices(self, devices: Sequence) -> None:
        """Unlease specific devices without an ownership check."""
        self.reclaim(None, devices)

    def mark_failed(self, device) -> None:
        """Simulated node failure: device leaves the pool permanently."""
        idx = {id(d): i for i, d in enumerate(self._devices)}
        with self._lock:
            i = idx.get(id(device))
            if i is not None:
                holder = self._leased.pop(i, None)
                self._failed.add(i)
                self._log("failed", holder, [i])
