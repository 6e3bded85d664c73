"""Carry state between the reference package and the port as numpy.

K-Means has no weights: its state is the datasets in the DataPlane and
the centroids.  :func:`load_numpy_state` places numpy arrays (as the
reference's ``np.asarray`` gives them) under their names on the port's
placement, with the same home pilots; :func:`state_to_numpy` reads them
back.  bfloat16 arrays (numpy's ``ml_dtypes`` extension type) cross as
their raw bits.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from repro_torch.analytics.engine import AnalyticsEngine
from repro_torch.core.dataplane import DataPlane, Placement, place


def to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with `arr`'s values and dtype (bfloat16 included)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:        # e.g. np.asarray of a jax.Array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The host copy of `t`; bfloat16 comes back as ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _split(target: Any) -> tuple:
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
