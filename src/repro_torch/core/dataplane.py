"""DataPlane: the shared data substrate under the Session layer.

This is the refactored ``PilotDataRegistry`` (the HDFS-NameNode
analogue), extended from single-pilot bookkeeping into a cross-pilot
data plane. It answers the paper's central question — local disk vs
Lustre, i.e. compute where the data lives vs move the data — as a
queryable runtime model:

  * **placement + replica tracking per pilot**: each named dataset has
    a home set of pilot uids (who holds a replica) in addition to its
    device-level placement.  Device-level locality is the fallback for
    data that was never attributed to a pilot;
  * **transfer-cost model**: per-byte costs for the three links of the
    paper's deployment — intra-pilot reshard (local disk), inter-pilot
    copy (node-to-node), global-FS spool (Lustre).  The Session's placer
    compares ``locality_score - movement_cost``;
  * **lineage**: each dataset can record the stage that produced it and
    the inputs it was derived from, so a replica lost to device failure
    can be re-materialized by re-running the producer;
  * **moved-bytes ledger**: every byte that crosses a link is recorded
    through the public :meth:`record_moved` — per-link and per-reason.

Arrays are :class:`ShardedTensor` records: per-device row blocks plus a
:class:`Placement` (the device tuple and ``block`` or ``replicated``).
A placement carries the resource manager's own device objects, never
devices rebuilt from ``tensor.device``: eviction, locality and lease
reclaim match devices by identity, and a rebuilt ``torch.device`` is
equal to the pool's but is not the same object.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..optim.compression import dequantize_int8, quantize_int8

# pseudo-pilot uid for the global-FS archive tier: a dataset spooled out
# over the GFS link keeps an archival replica under this home, so pilot
# caches may evict their copies without it being the "last replica"
GFS_ARCHIVE = "@gfs"

BLOCK = "block"            # rows split across the placement's data axis
REPLICATED = "replicated"  # one full copy on every device


class Placement:
    """Where a :class:`ShardedTensor` lives: the device tuple and its kind.

    ``block`` splits rows into ``len(devices) // tp`` blocks; block ``i``
    lives on ``devices[i*tp:(i+1)*tp]`` (replicated across the ``tp``
    devices of a grid row, as a ``P("data")`` spec on a (dp, tp) mesh).
    ``replicated`` keeps one full copy per device.  Equality is by kind,
    ``tp`` and device *identity*."""

    __slots__ = ("devices", "kind", "tp")

    def __init__(self, devices: Sequence, kind: str = REPLICATED, tp: int = 1):
        if kind not in (BLOCK, REPLICATED):
            raise ValueError(f"unknown placement kind {kind!r}")
        if not devices:
            raise ValueError("placement over an empty device tuple")
        if kind == BLOCK and len(devices) % tp:
            raise ValueError(f"{len(devices)} devices do not form rows "
                             f"of tp={tp}")
        self.devices = tuple(devices)
        self.kind = kind
        self.tp = tp if kind == BLOCK else 1

    @property
    def n_blocks(self) -> int:
        return len(self.devices) // self.tp if self.kind == BLOCK else 1

    @property
    def device_set(self) -> Set:
        return set(self.devices)

    def _key(self) -> Tuple:
        return (self.kind, self.tp, tuple(id(d) for d in self.devices))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Placement) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Placement({self.kind}, tp={self.tp}, "
                f"devices={list(self.devices)})")


class DeviceGrid:
    """A (dp, tp) grid of pool devices: the port's stand-in for a
    ``jax.sharding.Mesh``.  ``devices`` is an object ndarray, so
    ``grid.devices.flat`` and ``grid.devices.shape`` read as on a Mesh."""

    def __init__(self, devices: Sequence, tp: int = 1,
                 axis_names: Sequence[str] = ("data", "model")):
        devs = list(devices)
        dp = len(devs) // tp
        grid = np.empty(dp * tp, dtype=object)
        for i, d in enumerate(devs[: dp * tp]):
            grid[i] = d
        self.devices = grid.reshape(dp, tp)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def block_placement(self, axis: str = "data") -> Placement:
        """Rows split over `axis`, replicated over the other axis."""
        grid = self.devices
        if self.axis_names.index(axis) == 1:
            grid = grid.T
        return Placement(tuple(grid.flat), BLOCK, tp=grid.shape[1])


def _as_tensor(data: Any) -> torch.Tensor:
    if isinstance(data, ShardedTensor):
        return data.full()
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.ascontiguousarray(data))


class ShardedTensor:
    """A named dataset's buffer: one tensor per placement device.

    For ``block`` placements ``blocks[j]`` holds row block ``j // tp``;
    for ``replicated`` ones every entry is the full tensor.  ``nbytes``
    is the logical size (one copy), as ``jax.Array.nbytes`` is."""

    def __init__(self, blocks: Sequence[torch.Tensor], placement: Placement):
        if len(blocks) != len(placement.devices):
            raise ValueError(f"{len(blocks)} blocks for "
                             f"{len(placement.devices)} devices")
        self.blocks = tuple(blocks)
        self.placement = placement

    # ---------------------------------------------------------- geometry
    def row_blocks(self) -> List[Tuple[torch.Tensor, Any]]:
        """(block, pool device) per distinct row block, in row order."""
        step = self.placement.tp
        return [(self.blocks[j], self.placement.devices[j])
                for j in range(0, len(self.blocks), step)]

    @property
    def shape(self) -> Tuple[int, ...]:
        first = self.blocks[0]
        if self.placement.kind == REPLICATED:
            return tuple(first.shape)
        rows = sum(b.shape[0] for b, _ in self.row_blocks())
        return (rows,) + tuple(first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b, _ in self.row_blocks())

    def device_set(self) -> Set:
        return self.placement.device_set

    # ------------------------------------------------------------- views
    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default: the first placement
        device)."""
        device = self.placement.devices[0] if device is None else device
        parts = [b.to(device) for b, _ in self.row_blocks()]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def to_numpy(self) -> np.ndarray:
        return self.full(torch.device("cpu")).numpy()


def place(data: Any, placement: Placement) -> ShardedTensor:
    """Lay `data` (numpy, tensor or ShardedTensor) out on `placement`."""
    x = _as_tensor(data)
    if placement.kind == REPLICATED:
        return ShardedTensor([x.to(d) for d in placement.devices], placement)
    parts = torch.tensor_split(x, placement.n_blocks)
    blocks = [parts[j // placement.tp].to(d).contiguous()
              for j, d in enumerate(placement.devices)]
    return ShardedTensor(blocks, placement)


def replicated_sharding(devices: Sequence) -> Placement:
    """Fully-replicated placement over the UNIQUE devices of a slice.

    Dry-run pilots alias one device object across many lease slots; one
    copy per distinct device is kept, so every replicate-onto-a-pilot
    site goes through this helper."""
    uniq, seen = [], set()
    for d in devices:
        if id(d) not in seen:
            seen.add(id(d))
            uniq.append(d)
    if not uniq:
        raise ValueError("replicated_sharding of an empty device slice")
    return Placement(uniq, REPLICATED)


class Link:
    """The three data paths of the paper's Fig-8 comparison."""
    ICI = "ici"    # intra-pilot reshard (local-disk path: data stays put)
    DCN = "dcn"    # inter-pilot copy (node-to-node over the datacenter net)
    GFS = "gfs"    # global-FS spool (the Lustre path: persist + re-read)

    ALL = (ICI, DCN, GFS)


@dataclasses.dataclass
class TransferCostModel:
    """Per-byte movement costs (seconds/byte), one per link class.

    Defaults reflect the paper's ordering ICI << DCN << Lustre.  The
    ``runtime_affinity`` term is the consolidation pull: an analytics
    stage prefers a long-lived analytics-runtime pilot over paying the
    Mode-I cluster-spawn overhead inside an HPC pilot — unless moving
    its inputs there costs more than the affinity is worth.
    """
    ici_cost_per_byte: float = 1e-12
    dcn_cost_per_byte: float = 2e-10
    gfs_cost_per_byte: float = 1e-9
    runtime_affinity: float = 2.0
    # staging benchmarks: when True, every pilot-level move/replicate
    # sleeps its modeled movement_cost so wall-clock measurements see
    # transfer time (capped per transfer); default off — scoring-only
    # callers are unaffected
    simulate_time: bool = False
    max_simulated_s: float = 5.0

    def cost_per_byte(self, link: str) -> float:
        try:
            return {Link.ICI: self.ici_cost_per_byte,
                    Link.DCN: self.dcn_cost_per_byte,
                    Link.GFS: self.gfs_cost_per_byte}[link]
        except KeyError:
            raise ValueError(f"unknown link {link!r}; valid links: "
                             f"{', '.join(Link.ALL)}") from None

    def movement_cost(self, nbytes: int, link: str) -> float:
        return nbytes * self.cost_per_byte(link)


@dataclasses.dataclass
class Lineage:
    """How a dataset came to be: producer stage + the inputs it read.
    The Session resolves the producer callable from its stage registry —
    storing closures here would pin whole training states in the
    long-lived DataPlane."""
    stage: str
    inputs: Tuple[str, ...] = ()


class PilotData:
    """A named sharded tensor with known placement (the HDFS-block set).

    A *virtual* dataset (``array is None``) is accounting-only: a
    declared byte size with pilot-level replica tracking but no backing
    buffer.  ``itemsize`` is the element width the int8
    wire-compression ratio is derived from.
    """

    def __init__(self, name: str, array: Optional[ShardedTensor],
                 nbytes: Optional[int] = None, itemsize: int = 4):
        if array is not None and not isinstance(array, ShardedTensor):
            raise TypeError(f"dataset {name!r} must be a ShardedTensor "
                            f"(use dataplane.place), got {type(array)!r}")
        self.name = name
        self.array = array
        self._nbytes = nbytes
        self.itemsize = itemsize

    @property
    def nbytes(self) -> int:
        return self._nbytes if self.array is None else self.array.nbytes

    @property
    def is_virtual(self) -> bool:
        return self.array is None

    def device_set(self) -> Set:
        if self.array is None:
            return set()
        return self.array.device_set()

    def locality(self, devices: Sequence) -> float:
        """Fraction of this data's devices contained in `devices`."""
        mine = self.device_set()
        if not mine:
            return 1.0
        return len(mine & set(devices)) / len(mine)


class DataPlane:
    def __init__(self, cost_model: Optional[TransferCostModel] = None):
        self.cost_model = cost_model or TransferCostModel()
        self._data: Dict[str, PilotData] = {}
        self._home: Dict[str, Set[str]] = {}       # name -> pilot uids
        self._lineage: Dict[str, Lineage] = {}
        self._moved_bytes = 0
        self._moved_by_link: Dict[str, int] = {l: 0 for l in Link.ALL}
        self._moved_by_reason: Dict[str, int] = {}
        self._compressed_saved = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------- registry
    def put(self, name: str, array: ShardedTensor, *,
            pilot: Optional[str] = None,
            lineage: Optional[Lineage] = None) -> PilotData:
        """Register (or replace) a dataset; optionally attribute it to a
        home pilot and record its lineage."""
        pd = PilotData(name, array)
        with self._lock:
            self._data[name] = pd
            if pilot is not None:
                self._home[name] = {pilot}
            else:
                self._home.pop(name, None)
            if lineage is not None:
                self._lineage[name] = lineage
        return pd

    def put_virtual(self, name: str, nbytes: int, *, pilot: str,
                    itemsize: int = 4,
                    lineage: Optional[Lineage] = None) -> PilotData:
        """Register an accounting-only dataset: `nbytes` attributed to
        `pilot` with no backing tensor (see :class:`PilotData`).  Replica
        tracking, locality scoring, ledgered movement and GFS spooling
        all work; device-level operations skip it."""
        pd = PilotData(name, None, nbytes=int(nbytes), itemsize=itemsize)
        with self._lock:
            self._data[name] = pd
            self._home[name] = {pilot}
            if lineage is not None:
                self._lineage[name] = lineage
        return pd

    def remove(self, name: str) -> bool:
        """Forget a dataset entirely (all replicas + lineage).  Returns
        whether it existed."""
        with self._lock:
            existed = self._data.pop(name, None) is not None
            self._home.pop(name, None)
            self._lineage.pop(name, None)
        return existed

    def get(self, name: str) -> PilotData:
        return self._data[name]

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def names(self) -> List[str]:
        return list(self._data)

    # ------------------------------------------------------ replica tracking
    def home_pilots(self, name: str) -> Set[str]:
        return set(self._home.get(name, ()))

    def add_replica(self, name: str, pilot: str) -> None:
        with self._lock:
            self._home.setdefault(name, set()).add(pilot)

    def resident_on(self, name: str, pilot: str) -> Optional[bool]:
        """True/False if home tracking knows; None if never attributed."""
        home = self._home.get(name)
        return None if home is None else pilot in home

    def drop_replica(self, name: str, pilot: str, *,
                     keep_last: bool = True) -> bool:
        """Forget one pilot's replica of `name` (LRU cache eviction).
        With ``keep_last`` (the default) the LAST replica is never
        dropped — eviction must not lose a dataset.  Returns whether
        the replica was dropped."""
        with self._lock:
            home = self._home.get(name)
            if home is None or pilot not in home:
                return False
            if keep_last and not (home - {pilot}):
                return False
            home.discard(pilot)
            return True

    def drop_pilot_replicas(self, pilot: str) -> List[str]:
        """A pilot's replicas are gone (failure/shutdown). Returns the
        names left with NO replica — candidates for re-materialization
        via their lineage."""
        lost = []
        with self._lock:
            for name, home in self._home.items():
                home.discard(pilot)
                if not home:
                    lost.append(name)
        return lost

    def lineage_of(self, name: str) -> Optional[Lineage]:
        return self._lineage.get(name)

    # ------------------------------------------------------------- locality
    def locality_score(self, names: Sequence[str], devices: Sequence) -> float:
        """Byte-weighted device-level locality of `names` w.r.t.
        `devices` (1 = all local). Used by the intra-pilot scheduler."""
        items = [self._data[n] for n in names if n in self._data]
        total = sum(p.nbytes for p in items)
        if not total:
            return 1.0
        return sum(p.locality(devices) * p.nbytes for p in items) / total

    def pilot_locality(self, names: Sequence[str], pilot: str,
                       devices: Sequence = ()) -> float:
        """Byte-weighted locality of `names` w.r.t. a *pilot*.  Replica
        tracking wins when present (distinct pilots may alias the same
        physical devices in dry-runs); device overlap is the fallback."""
        items = [(n, self._data[n]) for n in names if n in self._data]
        total = sum(p.nbytes for _, p in items)
        if not total:
            return 1.0
        score = 0.0
        for n, p in items:
            res = self.resident_on(n, pilot)
            frac = p.locality(devices) if res is None else float(res)
            score += frac * p.nbytes
        return score / total

    def bytes_nonresident(self, names: Sequence[str], pilot: str,
                          devices: Sequence = ()) -> int:
        """Bytes that would have to cross a link to make `names` fully
        resident on `pilot` — the `bytes` input of the placer's
        ``movement_cost(bytes, link)`` term."""
        moved = 0
        for n in names:
            if n not in self._data:
                continue
            p = self._data[n]
            res = self.resident_on(n, pilot)
            frac = p.locality(devices) if res is None else float(res)
            moved += int(p.nbytes * (1.0 - frac))
        return moved

    # ------------------------------------------------------------- movement
    def _simulate(self, nbytes: int, link: str) -> None:
        """Pay the modeled transfer time in wall-clock (benchmarks set
        ``cost_model.simulate_time``); a no-op otherwise.  Called OUTSIDE
        the lock — concurrent transfers overlap, as real links would."""
        if self.cost_model.simulate_time and nbytes:
            time.sleep(min(self.cost_model.movement_cost(nbytes, link),
                           self.cost_model.max_simulated_s))

    def record_moved(self, nbytes: int, link: str = Link.DCN,
                     reason: str = "") -> None:
        """Public ledger entry: `nbytes` crossed `link`.  The ONLY way
        moved bytes are accounted — callers never touch the counters."""
        if link not in Link.ALL:
            raise ValueError(f"unknown link {link!r}; valid links: "
                             f"{', '.join(Link.ALL)}")
        with self._lock:
            self._moved_bytes += nbytes
            self._moved_by_link[link] += nbytes
            if reason:
                self._moved_by_reason[reason] = \
                    self._moved_by_reason.get(reason, 0) + nbytes

    def reshard_to(self, name: str, placement: Placement, *,
                   link: str = Link.ICI,
                   reason: str = "reshard") -> ShardedTensor:
        """Move data to a new placement; bytes recorded on `link`."""
        pd = self._data[name]
        if pd.array.placement == placement:
            return pd.array
        moved = place(pd.array, placement)
        with self._lock:
            self._data[name] = PilotData(name, moved)
        self.record_moved(pd.nbytes, link, reason)
        return moved

    def move_to_pilot(self, name: str, pilot: str,
                      placement: Optional[Placement], *,
                      link: str = Link.DCN,
                      reason: str = "") -> Tuple[Optional[ShardedTensor], int]:
        """Inter-pilot move: re-place onto the target pilot's devices and
        re-home the dataset there.  Only the non-resident bytes pay the
        link cost (a replica already on the target moves nothing).
        Returns (moved tensor, bytes recorded on `link`).

        Virtual datasets take the accounting-only path: `placement` may
        be None, no copy happens, but the non-resident bytes are
        simulated and ledgered exactly like a materialized move."""
        pd = self._data[name]
        if pd.is_virtual:
            nonres = self.bytes_nonresident([name], pilot)
            self._simulate(nonres, link)
            with self._lock:
                self._home[name] = {pilot}
            if nonres:
                self.record_moved(nonres, link, reason or f"move:{name}")
            return None, nonres
        nonres = self.bytes_nonresident([name], pilot,
                                        list(placement.device_set))
        moved = place(pd.array, placement)
        self._simulate(nonres, link)
        with self._lock:
            self._data[name] = PilotData(name, moved)
            self._home[name] = {pilot}
        if nonres:
            self.record_moved(nonres, link, reason or f"move:{name}")
        return moved, nonres

    def replicate_to(self, name: str, pilot: str,
                     placement: Optional[Placement], *,
                     link: str = Link.DCN, reason: str = "",
                     compress: Optional[str] = None,
                     min_compress_bytes: int = 1 << 16
                     ) -> Tuple[Optional[ShardedTensor], int]:
        """Prefetch-path move: like :meth:`move_to_pilot` but the target
        pilot is ADDED to the home set — existing replicas survive, so
        a later reader on the old pilot hits its cached copy.

        With ``compress="int8"`` and a DCN/GFS transfer of at least
        ``min_compress_bytes`` non-resident bytes, the payload crosses
        the wire int8-quantized (:mod:`repro_torch.optim.compression`):
        the ledger records the COMPRESSED size and the savings accumulate
        under :attr:`compressed_bytes_saved`.  The landed replica is
        the dequantized reconstruction (lossy by one quantization step).
        Returns (landed tensor, bytes recorded on `link`)."""
        pd = self._data[name]
        if pd.is_virtual:
            nonres = self.bytes_nonresident([name], pilot)
            wire = nonres
            if (compress == "int8" and link in (Link.DCN, Link.GFS)
                    and nonres >= min_compress_bytes and pd.itemsize > 1):
                wire = max(nonres // pd.itemsize, 1)
                with self._lock:
                    self._compressed_saved += nonres - wire
            self._simulate(wire, link)
            with self._lock:
                self._home.setdefault(name, set()).add(pilot)
            if nonres:
                self.record_moved(wire, link, reason or f"replicate:{name}")
            return None, (wire if nonres else 0)
        nonres = self.bytes_nonresident([name], pilot,
                                        list(placement.device_set))
        if nonres == 0:
            with self._lock:
                self._home.setdefault(name, set()).add(pilot)
            return pd.array, 0
        arr = pd.array
        wire = nonres
        if (compress == "int8" and link in (Link.DCN, Link.GFS)
                and nonres >= min_compress_bytes
                and arr.dtype.is_floating_point):
            q, scale = quantize_int8(arr.full())
            landed = place(q, placement)
            moved = ShardedTensor(
                [dequantize_int8(b, scale).to(arr.dtype) for b in landed.blocks],
                placement)
            q_nbytes = q.numel() * q.element_size()
            wire = max(int(nonres * (q_nbytes / max(pd.nbytes, 1))), 1)
            with self._lock:
                self._compressed_saved += nonres - wire
        else:
            moved = place(arr, placement)
        self._simulate(wire, link)
        with self._lock:
            self._data[name] = PilotData(name, moved)
            self._home.setdefault(name, set()).add(pilot)
        self.record_moved(wire, link, reason or f"replicate:{name}")
        return moved, wire

    def spool_out(self, name: str, *, link: str = Link.GFS,
                  reason: str = "stage-out") -> int:
        """Stage-out spool: push a produced dataset over `link` (the
        HDFS-distcp/Lustre-persist analogue).  A GFS spool leaves an
        archival replica under :data:`GFS_ARCHIVE`, which makes every
        pilot copy of the dataset cache-evictable.  Returns the bytes
        ledgered."""
        pd = self._data.get(name)
        if pd is None:
            raise KeyError(f"cannot stage out unknown dataset {name!r}")
        self._simulate(pd.nbytes, link)
        self.record_moved(pd.nbytes, link, reason)
        if link == Link.GFS:
            with self._lock:
                self._home.setdefault(name, set()).add(GFS_ARCHIVE)
        return pd.nbytes

    # ------------------------------------------------------------- eviction
    def datasets_on_devices(self, devices: Sequence,
                            pilot: Optional[str] = None) -> List[str]:
        """Names whose shards touch any of `devices` (matched by device
        identity); with `pilot`, restricted to datasets that pilot
        (possibly) holds a replica of (never-attributed datasets are
        included — device overlap is the fallback truth)."""
        ids = {id(d) for d in devices}
        with self._lock:
            names = list(self._data)
        out = []
        for name in names:
            pd = self._data.get(name)
            if pd is None:
                continue
            if pilot is not None and self.resident_on(name, pilot) is False:
                continue
            if any(id(d) in ids for d in pd.device_set()):
                out.append(name)
        return out

    def evict_devices(self, devices: Sequence, placement: Placement, *,
                      pilot: Optional[str] = None, link: str = Link.ICI,
                      reason: str = "drain-evict") -> Dict[str, int]:
        """Drain-time re-replication: every dataset with shards on
        `devices` is moved onto `placement` (the surviving slice) so the
        chips can leave without losing named data.  Only the fraction of
        each dataset's devices being drained pays the link — those bytes
        land on the ledger under `reason`.  Returns name -> bytes."""
        ids = {id(d) for d in devices}
        moved: Dict[str, int] = {}
        for name in self.datasets_on_devices(devices, pilot):
            pd = self._data.get(name)
            if pd is None:
                continue
            mine = pd.device_set()
            frac = (len({d for d in mine if id(d) in ids}) / len(mine)
                    if mine else 0.0)
            nbytes = int(pd.nbytes * frac)
            arr = place(pd.array, placement)
            with self._lock:
                self._data[name] = PilotData(name, arr)
            if nbytes:
                self.record_moved(nbytes, link, reason)
            moved[name] = nbytes
        return moved

    # ---------------------------------------------------------------- stats
    @property
    def moved_bytes(self) -> int:
        return self._moved_bytes

    def moved_by_link(self, link: str) -> int:
        return self._moved_by_link.get(link, 0)

    @property
    def compressed_bytes_saved(self) -> int:
        return self._compressed_saved

    def ledger(self) -> Dict[str, Any]:
        with self._lock:
            return {"total": self._moved_bytes,
                    "by_link": dict(self._moved_by_link),
                    "by_reason": dict(self._moved_by_reason),
                    "compressed_bytes_saved": self._compressed_saved}


# Backwards-compatible name: the seed's single-pilot registry grew into
# the cross-pilot DataPlane; old call sites keep working unchanged.
PilotDataRegistry = DataPlane
