"""Checkpoint/restart substrate.

The port of ``repro.checkpoint.manager``, with the same on-disk layout,
so a checkpoint written by either package restores in the other:
  * ``step-XXXXXXXX/leaves.npz`` + ``manifest.json``; one array per
    leaf, keyed by its tree path joined by ``/`` (``params/segments/0/…``,
    ``opt/m/…``, ``step``); bfloat16 and fp8 leaves stored as their raw
    ``uint16``/``uint8`` bits (numpy has no such dtypes);
  * async save: every leaf is copied to a fresh host buffer on the
    caller's thread (a copy on the CPU too, so an in-place optimizer
    step after ``save`` returns cannot change what is written),
    serialization on a background thread, one save in flight;
  * atomic publish: write to a tmp dir, then rename;
  * retention: keep the newest ``keep`` checkpoints;
  * ``restore`` reads into the structure and dtypes of a target tree and
    places every leaf on a given device;
  * sharded states: a DTensor leaf is saved as its full array (every
    rank gathers it with ``full_tensor()``, leaf by leaf, so every rank
    calls ``save``; rank 0 alone copies it to the host and writes), and
    ``restore(..., mesh=, plan=)`` places each leaf on the current mesh
    by the plan as it is read, whatever mesh saved it: a checkpoint of a
    4-device run restores onto 2 devices, or 1.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.util import Device, resolve_device, tree_paths

# torch dtype -> (raw torch view, raw numpy dtype) for what numpy lacks
_RAW_DTYPES = {torch.bfloat16: (torch.int16, np.uint16),
               torch.float8_e4m3fn: (torch.uint8, np.uint8),
               torch.float8_e5m2: (torch.uint8, np.uint8)}


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(leaf: Any) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    # a copy for every device: .cpu() of a CPU tensor is the tensor itself
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype in _RAW_DTYPES:
        view, raw = _RAW_DTYPES[t.dtype]
        return t.view(view).numpy().view(raw)
    return t.numpy()


def _writer() -> bool:
    """Rank 0 of a process group (or a process without one) writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _flatten(tree: Any, host: bool = True) -> Dict[str, np.ndarray]:
    """Every leaf as a host array, leaf by leaf.  A rank with `host` false
    only joins the gathers of the DTensor leaves and copies nothing."""
    out = {}
    for path, leaf in tree_paths(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()      # a collective: every rank joins
        if host:
            out[_key(path)] = _to_numpy(leaf)
    return out


def _from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    # (np.ascontiguousarray makes a 0-d array 1-d: reshape it back)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype in _RAW_DTYPES:
        view, raw = _RAW_DTYPES[dtype]
        bits = arr.view(raw).view(
            np.int16 if view is torch.int16 else np.uint8)
        return torch.from_numpy(bits).view(dtype)
    return torch.from_numpy(arr).to(dtype)


def _rebuild(target: Any, prefix: tuple, leaf_fn) -> Any:
    if isinstance(target, dict):
        return {k: _rebuild(v, prefix + (k,), leaf_fn)
                for k, v in target.items()}
    if isinstance(target, (tuple, list)):
        return type(target)(_rebuild(v, prefix + (i,), leaf_fn)
                            for i, v in enumerate(target))
    return leaf_fn(prefix, target)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- save
    def save(self, state: Any, step: int, *, blocking: bool = False) -> None:
        writer = _writer()
        arrays = _flatten(state, writer)  # device->host on caller thread
        manifest = {"step": int(step),
                    "leaves": {k: [list(v.shape), str(v.dtype)]
                               for k, v in arrays.items()}}

        def _write():
            tmp = os.path.join(self.dir, f".tmp-{step:08d}")
            final = os.path.join(self.dir, f"step-{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)         # atomic publish
            self._gc()

        self.wait()                       # one in-flight save at a time
        if not writer:
            return
        if self.async_save and not blocking:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self):
        return [int(d.split("-")[1]) for d in os.listdir(self.dir)
                if d.startswith("step-")]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, target: Any, step: Optional[int] = None,
                device: Device = "cuda", mesh=None, plan=None) -> Any:
        """Restore into the structure and dtypes of `target` (a tree whose
        leaves have ``.dtype``: tensors, fake or meta tensors), every leaf
        placed on `device` (the card unless the caller asks for the CPU);
        with `mesh` and `plan`, every leaf of more than 0 dims becomes a
        DTensor on `mesh` placed by ``plan.param_specs``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        self.wait()
        path = os.path.join(self.dir, f"step-{step:08d}")
        device = resolve_device(device)
        if mesh is not None:
            from repro_torch.sharding import parallel
            specs = plan.param_specs(target)

        def leaf_fn(pth, leaf):
            t = _from_numpy(data[_key(pth)], leaf.dtype).to(device)
            if mesh is None or t.ndim == 0:
                return t
            spec = functools.reduce(lambda sub, k: sub[k], pth, specs)
            return parallel.distribute(t, mesh, spec)   # one leaf at a time

        with np.load(os.path.join(path, "leaves.npz")) as data:
            return _rebuild(target, (), leaf_fn)
