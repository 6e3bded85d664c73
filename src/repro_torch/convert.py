"""Carry state between the reference package and the port as numpy.

K-Means has no weights: its state is the datasets in the DataPlane and
the centroids.  :func:`load_numpy_state` places numpy arrays (as the
reference's ``np.asarray`` gives them) under their names on the port's
placement, with the same home pilots; :func:`state_to_numpy` reads them
back.  bfloat16 arrays (numpy's ``ml_dtypes`` extension type) cross as
their raw bits.  Model params and train states cross as trees of numpy
arrays (:func:`params_from_numpy`, :func:`train_state_from_numpy` and
their inverses).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.dataplane import DataPlane, Placement, place
from repro_torch.util import resolve_device, tree_map


def to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with `arr`'s values and dtype (bfloat16 included)."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:     # (ascontiguousarray makes 0-d 1-d)
        arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:        # e.g. np.asarray of a jax.Array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The host copy of `t` (a DTensor's full tensor); bfloat16 comes
    back as ``ml_dtypes.bfloat16``."""
    from torch.distributed.tensor import DTensor   # kept off the core's import
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Any, device: Any = "cuda") -> Any:
    """The same nested dicts and lists with every numpy leaf a tensor on
    `device` (e.g. the reference's ``jax.tree.map(np.asarray, params)``)."""
    device = resolve_device(device)
    return tree_map(lambda a: to_tensor(a).to(device), tree)


def params_to_numpy(tree: Any) -> Any:
    """The same nested dicts and lists with every tensor leaf a numpy
    array (bfloat16 as ``ml_dtypes.bfloat16``)."""
    return tree_map(to_numpy, tree)


def train_state_from_numpy(state: Any, device: Any = "cuda") -> Any:
    """A reference train state, ``{"params", "opt": {"m", "v"}, "step"}``
    as ``jax.tree.map(np.asarray, state)`` gives it, as the port's: the
    same tree of tensors on `device` (``step`` a 0-d int32 tensor), each
    a copy."""
    device = resolve_device(device)
    # copies: the optimizer updates the state in place, and a CPU tensor
    # made from numpy would share (and so change) the caller's arrays
    return tree_map(lambda a: to_tensor(a).to(device, copy=True), state)


def train_state_to_numpy(state: Any) -> Any:
    """The port's train state as the reference's tree of numpy arrays."""
    return params_to_numpy(state)


def _split(target: Any) -> tuple:
    # imported here: the core's Session imports this module, and the
    # engine imports the core
    from repro_torch.analytics.engine import AnalyticsEngine
    if isinstance(target, AnalyticsEngine):
        return target.data, target.block_sharding()
    if isinstance(target, DataPlane):
        return target, None
    raise TypeError(f"expected a DataPlane or AnalyticsEngine, "
                    f"got {type(target)!r}")


def load_numpy_state(target: Any, arrays: Mapping[str, np.ndarray], *,
                     homes: Optional[Mapping[str, Iterable[str]]] = None,
                     placement: Optional[Placement] = None) -> None:
    """Put each array under its name.  `target` is an AnalyticsEngine
    (block placement over its grid) or a DataPlane (then `placement` is
    required).  `homes` maps a name to its home pilot uids."""
    data, default = _split(target)
    where = placement or default
    if where is None:
        raise ValueError("a bare DataPlane needs placement=")
    for name, arr in arrays.items():
        pilots = sorted((homes or {}).get(name, ()))
        data.put(name, place(to_tensor(arr), where),
                 pilot=pilots[0] if pilots else None)
        for p in pilots[1:]:
            data.add_replica(name, p)


def state_to_numpy(target: Any,
                   names: Optional[Iterable[str]] = None
                   ) -> Dict[str, np.ndarray]:
    """Host copies of the named datasets (default: every materialized
    one) of a DataPlane or AnalyticsEngine."""
    data, _ = _split(target)
    names = list(names) if names is not None else [
        n for n in data.names() if not data.get(n).is_virtual]
    return {n: to_numpy(data.get(n).array.full()) for n in names}
