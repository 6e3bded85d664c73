"""KV-cache pages as DataPlane datasets.

The port of ``repro.serve.kv_pages``.  The paper's locality-vs-movement
question applied to inference: a request's KV-cache is the data the
decode stage is bound to, the way a Hadoop task is bound to its HDFS
block.  This module registers each request's cache as fixed-size
*pages* — virtual DataPlane datasets (declared bytes, no backing
tensor; the actual rows live spliced inside a decode engine's stacked
cache) — so KV placement rides the exact machinery analytics data
already uses:

  * allocation on the prefill pilot (`alloc`), page size in tokens with
    the bytes/token rate derived from the model's cache shapes;
  * ledgered DCN shipment when a prefilled cache is spliced into a
    decode engine on another pilot (`splice_to`, reason ``kv-splice``),
    with optional int8 wire compression — the HDFS-block-transfer
    analogue, visible on the same byte ledger as everything else;
  * `spool`/`restore` of cold pages through the staging tier (GFS
    archive + local-replica eviction, then promotion back);
  * `free` when a request's lifetime truly ends.

Locality queries (`locality`, `bytes_nonresident`) feed the router's
``affinity + locality − movement_cost`` dispatch score.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from repro_torch.core.dataplane import DataPlane, GFS_ARCHIVE, Link
from repro_torch.core.staging import DataRef


def kv_cache_rates(cfg) -> Dict[str, int]:
    """(bytes/token, fixed bytes) of one request's decode cache.

    Derived from ``init_caches`` shapes on the meta device — attention
    caches grow linearly in max_seq (windowed segments saturate at the
    window, ignored here: page accounting is an upper bound), SSM state
    is sequence-length-independent and lands in ``fixed_bytes``.
    """
    from repro_torch.models import transformer

    def nbytes_at(s: int) -> int:
        caches = transformer.init_caches(cfg, 1, s, device="meta")
        return sum(t.numel() * t.element_size()
                   for c in caches for t in c.values())

    b1, b2 = nbytes_at(1), nbytes_at(2)
    per_token = max(b2 - b1, 1)
    return {"bytes_per_token": per_token,
            "fixed_bytes": max(b1 - per_token, 0),
            "itemsize": cfg.param_dtype.itemsize}


@dataclasses.dataclass
class KVLease:
    """One request's page set: names registered on the DataPlane."""
    uid: int                 # request uid
    pages: List[str]
    tokens: int
    nbytes: int              # total across pages (incl. fixed state)
    spooled: bool = False


class KVPageManager:
    """Allocates, ships, spools and frees KV pages on a DataPlane."""

    def __init__(self, dataplane: DataPlane, *, page_tokens: int = 16,
                 bytes_per_token: Optional[int] = None,
                 fixed_bytes: int = 0, itemsize: int = 2,
                 cfg=None, compress: Optional[str] = None):
        if bytes_per_token is None:
            if cfg is None:
                raise ValueError("need bytes_per_token or cfg")
            rates = kv_cache_rates(cfg)
            bytes_per_token = rates["bytes_per_token"]
            fixed_bytes = rates["fixed_bytes"]
            itemsize = max(rates["itemsize"], 1)
        self.data = dataplane
        self.page_tokens = max(1, page_tokens)
        self.bytes_per_token = max(1, int(bytes_per_token))
        self.fixed_bytes = int(fixed_bytes)
        self.itemsize = max(1, itemsize)
        self.compress = compress
        self._leases: Dict[int, KVLease] = {}
        self._lock = threading.Lock()
        self.stats = {"pages_allocated": 0, "bytes_allocated": 0,
                      "splices": 0, "splice_bytes": 0, "local_splices": 0,
                      "spools": 0, "spool_bytes": 0,
                      "restores": 0, "restore_bytes": 0, "freed": 0}

    # ----------------------------------------------------------- allocation
    def bytes_for_tokens(self, n_tokens: int) -> int:
        n_pages = -(-max(1, n_tokens) // self.page_tokens)
        return n_pages * self.page_tokens * self.bytes_per_token \
            + self.fixed_bytes

    def alloc(self, uid: int, n_tokens: int, pilot: str) -> KVLease:
        """Register the request's pages, homed on `pilot` (where the
        prefill produced them)."""
        n_pages = -(-max(1, n_tokens) // self.page_tokens)
        page_bytes = self.page_tokens * self.bytes_per_token
        names, total = [], 0
        for i in range(n_pages):
            nb = page_bytes + (self.fixed_bytes if i == 0 else 0)
            name = f"kv/{uid}/p{i}"
            self.data.put_virtual(name, nb, pilot=pilot,
                                  itemsize=self.itemsize)
            names.append(name)
            total += nb
        lease = KVLease(uid=uid, pages=names, tokens=n_tokens, nbytes=total)
        with self._lock:
            self._leases[uid] = lease
            self.stats["pages_allocated"] += n_pages
            self.stats["bytes_allocated"] += total
        return lease

    def lease(self, uid: int) -> Optional[KVLease]:
        with self._lock:
            return self._leases.get(uid)

    # ------------------------------------------------------------- locality
    def resident_pilot(self, uid: int) -> Optional[str]:
        """A pilot currently holding the request's pages (archive tier
        excluded); None if unknown or spooled-out-only."""
        lease = self.lease(uid)
        if lease is None:
            return None
        homes = self.data.home_pilots(lease.pages[0]) - {GFS_ARCHIVE}
        return next(iter(sorted(homes)), None)

    def locality(self, uid: int, pilot: str) -> float:
        lease = self.lease(uid)
        if lease is None:
            return 0.0
        return self.data.pilot_locality(lease.pages, pilot)

    def bytes_nonresident(self, uid: int, pilot: str) -> int:
        lease = self.lease(uid)
        if lease is None:
            return 0
        return self.data.bytes_nonresident(lease.pages, pilot)

    def bytes_on(self, pilot: str) -> int:
        """Live (non-spooled) KV bytes homed on `pilot`."""
        total = 0
        with self._lock:
            leases = list(self._leases.values())
        for lease in leases:
            for page in lease.pages:
                if self.data.resident_on(page, pilot):
                    total += self.data.get(page).nbytes
        return total

    # ------------------------------------------------------------- shipment
    def splice_to(self, uid: int, pilot: str, *, link: str = Link.DCN,
                  reason: str = "kv-splice") -> int:
        """Ship the request's pages to `pilot` (decode engine placement):
        non-resident bytes cross `link` — int8-compressed when the
        manager was built with ``compress="int8"`` — and the pages are
        re-homed there exclusively (a splice moves the cache, it does
        not copy it).  Returns the wire bytes ledgered; 0 for a
        local-pilot splice (the short-circuit read)."""
        lease = self.lease(uid)
        if lease is None:
            raise KeyError(f"no KV lease for request {uid}")
        wire = 0
        for page in lease.pages:
            old = self.data.home_pilots(page) - {pilot, GFS_ARCHIVE}
            _, w = self.data.replicate_to(page, pilot, None, link=link,
                                          reason=reason,
                                          compress=self.compress)
            wire += w
            for h in old:
                self.data.drop_replica(page, h, keep_last=True)
        with self._lock:
            self.stats["splices"] += 1
            self.stats["splice_bytes"] += wire
            if wire == 0:
                self.stats["local_splices"] += 1
        return wire

    # -------------------------------------------------------------- tiering
    def spool(self, uid: int, *, prefetcher=None,
              reason: str = "kv-spool") -> int:
        """Archive the request's pages to ``@gfs`` and drop the pilot
        replica (cold tier).  With a `prefetcher` the spool rides the
        staging pipeline asynchronously (``evict_after`` stage-out
        refs); otherwise it runs inline.  Returns the bytes ledgered
        (0 when async — they land on the prefetcher's stats)."""
        lease = self.lease(uid)
        if lease is None:
            raise KeyError(f"no KV lease for request {uid}")
        nbytes = 0
        if prefetcher is not None:
            refs = [DataRef(p, link_hint=Link.GFS, evict_after=True)
                    for p in lease.pages]
            prefetcher.request_many(refs, kind="out", reason=reason)
        else:
            for page in lease.pages:
                nbytes += self.data.spool_out(page, reason=reason)
                self.data.drop_replica(page, next(iter(
                    self.data.home_pilots(page) - {GFS_ARCHIVE}), ""),
                    keep_last=True)
        lease.spooled = True
        with self._lock:
            self.stats["spools"] += 1
            self.stats["spool_bytes"] += nbytes
        return nbytes

    def restore(self, uid: int, pilot: str, *,
                reason: str = "kv-restore") -> int:
        """Promote spooled pages back onto `pilot` over the GFS link
        (resuming a parked request).  Returns the wire bytes."""
        lease = self.lease(uid)
        if lease is None:
            raise KeyError(f"no KV lease for request {uid}")
        wire = 0
        for page in lease.pages:
            _, w = self.data.replicate_to(page, pilot, None, link=Link.GFS,
                                          reason=reason,
                                          compress=self.compress)
            wire += w
        lease.spooled = False
        with self._lock:
            self.stats["restores"] += 1
            self.stats["restore_bytes"] += wire
        return wire

    def free(self, uid: int) -> None:
        """The request is done and its cache rows reusable: forget the
        pages entirely."""
        with self._lock:
            lease = self._leases.pop(uid, None)
            if lease is None:
                return
            self.stats["freed"] += 1
        for page in lease.pages:
            self.data.remove(page)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"leases": len(self._leases), **self.stats}
