"""MapReduce-style analytics engine on a device grid (the Hadoop/Spark stage).

The paper's Hadoop stages are fine-grained data-parallel map/shuffle/
reduce tasks over HDFS blocks.  Here:
  * a dataset is a :class:`~repro_torch.core.dataplane.ShardedTensor`
    (blocks = per-device row blocks, registered in the DataPlane);
  * ``map`` is a block-local computation on the block's own device;
  * ``reduce`` sums the per-block partials onto the first device (the
    shuffle's all-to-one), in place of the reference's ``psum``;
  * ``map_reduce`` fuses both.

Two data paths, mirroring the paper's local-disk vs Lustre comparison:
  * data-local: compute where the blocks already live (RP-YARN path);
  * global-reshard: spool out and re-read first (RP/Lustre path) — the
    engine records moved bytes via the DataPlane ledger.
"""
from __future__ import annotations

import functools
import os
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.dataplane import (DataPlane, DeviceGrid, Link,
                                        Placement, ShardedTensor, place)


def _tree_map(fn: Callable, *trees: Any) -> Any:
    """Map `fn` over matching tensors of (nested) tuples/lists/dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


class AnalyticsEngine:
    def __init__(self, mesh: DeviceGrid, data: Optional[DataPlane] = None,
                 axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.data = data or DataPlane()
        self._exec_cache: dict[Any, Any] = {}

    # ------------------------------------------------------------- dataset
    def block_sharding(self) -> Placement:
        return self.mesh.block_placement(self.axis)

    def put(self, name: str, array: Any) -> None:
        """Register a dataset (numpy or tensor), split block-wise over the
        engine's grid."""
        self.data.put(name, place(array, self.block_sharding()))

    def get(self, name: str) -> ShardedTensor:
        return self.data.get(name).array

    # ------------------------------------------------------------ map/reduce
    def map_blocks(self, fn: Callable, name: str,
                   out_name: str) -> ShardedTensor:
        """Block-local map (Hadoop map phase; zero communication)."""
        x = self.ensure_local(name)
        mapped = ShardedTensor([fn(b) for b in x.blocks], x.placement)
        self.data.put(out_name, mapped)
        return mapped

    def map_reduce(self, map_fn: Callable, name: str, *,
                   extra_args: tuple = (), cache_key: Any = None) -> Any:
        """map + shuffle + reduce: per-block partials summed onto the
        first device.

        ``map_fn(block, *extra_args) -> tree of partial aggregates``;
        the reduce combiner is summation (sufficient for K-Means et al.).
        Each block runs on its own device with ``extra_args`` copied
        there.  ``cache_key`` re-uses the executor across rounds, as the
        reference re-uses its compiled function: the first ``map_fn``
        registered under a key is the one that runs.
        """
        x = self.ensure_local(name)
        key = cache_key if cache_key is not None else id(map_fn)
        fn = self._exec_cache.get(key)
        if fn is None:
            fn = functools.partial(self._map_blocks_and_sum, map_fn)
            self._exec_cache[key] = fn
        return fn(x, *extra_args)

    @staticmethod
    def _map_blocks_and_sum(map_fn: Callable, x: ShardedTensor,
                            *args: Any) -> Any:
        blocks = x.row_blocks()
        home = blocks[0][0].device
        total = None
        for block, dev in blocks:
            local = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                          for a in args)
            part = _tree_map(lambda t: t.to(home), map_fn(block, *local))
            total = part if total is None else _tree_map(torch.add, total, part)
        return total

    # ----------------------------------------------------------- data paths
    def ensure_local(self, name: str) -> ShardedTensor:
        """Data-local path: reshard only if placement mismatches (and count
        the moved bytes if it does — the locality-vs-movement trade-off)."""
        pd = self.data.get(name)
        want = self.block_sharding()
        if pd.array.placement == want:
            return pd.array
        return self.data.reshard_to(name, want, link=Link.ICI,
                                    reason="ensure-local")

    def global_reshard(self, name: str,
                       spool_dir: Optional[str] = None) -> ShardedTensor:
        """Global-FS path (Lustre analogue): per the paper, hybrid stages
        "involve persisting files and re-reading them" — the dataset is
        written out through the 'parallel filesystem' (``spool_dir``,
        default the temp directory) and re-read before re-blocking, vs
        the data-local path that computes on resident blocks.  Moved
        bytes recorded both ways."""
        pd = self.data.get(name)
        full = pd.array.full(torch.device("cpu"))      # device -> host
        bits = full.dtype == torch.bfloat16            # numpy has no bf16
        host = (full.view(torch.int16) if bits else full).numpy()
        fd, path = tempfile.mkstemp(dir=spool_dir, suffix=".pfs")
        try:
            with os.fdopen(fd, "wb") as f:             # persist ...
                np.save(f, host)
            self.data.record_moved(pd.nbytes, Link.GFS, "gfs-spool-write")
            reread = torch.from_numpy(np.load(path))   # ... and re-read
            self.data.record_moved(pd.nbytes, Link.GFS, "gfs-spool-read")
        finally:
            os.unlink(path)
        if bits:
            reread = reread.view(torch.bfloat16)
        re_blocked = place(reread, self.block_sharding())
        self.data.put(name, re_blocked)
        return re_blocked

    @property
    def moved_bytes(self) -> int:
        return self.data.moved_bytes
