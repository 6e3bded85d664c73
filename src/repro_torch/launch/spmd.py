"""One program on every device of a grid: the port's single controller.

JAX drives every device of a mesh from one process; PyTorch runs one
process per device.  :func:`run` takes a pilot's
:class:`~repro_torch.core.dataplane.DeviceGrid` and calls
``fn(mesh, *args)`` once per device, ``mesh`` being the grid's
``DeviceMesh`` in that rank's process group:

  * one device: inline, in this process, in a world-size-1 group
    (NCCL for a CUDA device, gloo for the CPU) that lives as long as the
    process (:func:`local_mesh`);
  * more devices: one process per device (``torch.multiprocessing``,
    spawn), gloo ranks on the CPU (n CPU slots of a pool are n ranks, as
    the pools alias one device object over n slots) and NCCL on CUDA
    cards.  Rendezvous goes through a ``file://`` store in a fresh
    temporary directory, so no port is taken.

It returns rank 0's result.  Any rank's exception is raised here with
that rank's traceback, and the other ranks are stopped; a rank that dies
without a word, or a call that outlasts `timeout`, raises too.  Results
and arguments cross processes as plain pickles (tensors by value).
"""
from __future__ import annotations

import atexit
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Tuple

import torch

_LOCAL_MESHES: Dict[Tuple, Any] = {}


class RankError(RuntimeError):
    """A rank of :func:`run` failed; the message holds its traceback."""


def grid_kind(grid) -> str:
    """The device type ("cuda" or "cpu") of a grid's devices."""
    return torch.device(next(iter(grid.devices.flat))).type


def mesh_device(mesh) -> torch.device:
    """This rank's device on a ``DeviceMesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _backend(kind: str) -> str:
    return "nccl" if kind == "cuda" else "gloo"


def local_mesh(grid):
    """The ``DeviceMesh`` of a one-device grid, in this process: starts a
    world-size-1 group the first time (a ``file://`` store in a temporary
    directory), and reuses it and the mesh afterwards."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import device_mesh
    if grid.size != 1:
        raise ValueError(f"local_mesh of a {grid.size}-device grid")
    kind = grid_kind(grid)
    dev = torch.device(next(iter(grid.devices.flat)))
    if kind == "cuda":
        torch.cuda.set_device(dev.index or 0)
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="repro-pg-")
        atexit.register(shutil.rmtree, tmp, True)
        store = os.path.join(tmp, "store")
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError("local_mesh: this process is a rank of a "
                           f"{dist.get_world_size()}-rank group")
    key = (kind, tuple(grid.devices.shape), tuple(grid.axis_names))
    if key not in _LOCAL_MESHES:
        _LOCAL_MESHES[key] = device_mesh(grid)
    return _LOCAL_MESHES[key]


def _rank_main(rank: int, world: int, init: str, kind: str, index: int,
               shape, names, blob: bytes, results) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    try:
        if kind == "cuda":
            torch.cuda.set_device(index)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(_backend(kind), init_method=init, rank=rank,
                                world_size=world)
        mesh = init_device_mesh(kind, shape, mesh_dim_names=names)
        fn, args = pickle.loads(blob)
        out = fn(mesh, *args)
        results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except BaseException:                      # report every failure
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(grid, fn: Callable, *args, timeout: float = 900.0) -> Any:
    """``fn(mesh, *args)`` on every device of `grid`; rank 0's result.
    `fn` and `args` must pickle (a module-level function)."""
    if grid.size == 1:
        return fn(local_mesh(grid), *args)
    import torch.multiprocessing as mp
    kind = grid_kind(grid)
    devices = [torch.device(d) for d in grid.devices.flat]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    blob = pickle.dumps((fn, args))
    with tempfile.TemporaryDirectory(prefix="repro-spmd-") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, grid.size, init, kind, devices[r].index or 0,
                  tuple(grid.devices.shape), tuple(grid.axis_names), blob,
                  results)) for r in range(grid.size)]
        for p in procs:
            p.start()
        done: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(done) < grid.size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spmd.run: {grid.size - len(done)} of {grid.size} "
                        f"ranks still running after {timeout:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        # a last report may be in flight: read once more
                        try:
                            rank, ok, payload = results.get(timeout=2.0)
                        except queue.Empty:
                            raise RankError(
                                f"spmd.run: ranks {dead} (rank, exit code) "
                                "ended without a result") from None
                    else:
                        continue
                if not ok:
                    raise RankError(f"rank {rank} of {grid.size} failed:\n"
                                    f"{payload}")
                done[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10 if len(done) == grid.size else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return pickle.loads(done[0])
