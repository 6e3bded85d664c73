"""Collective bytes per device, read from the collectives a step issues.

The role of ``repro.roofline.hlo``.  The reference parses the compiled
HLO; the port has no HLO, and its sharded step issues every collective
explicitly: DTensor's redistributions and the sums and sequence
gathers of ``sharding/parallel.py`` as ``_c10d_functional`` ops, and
its in-place gradient sums (``copy_in``, ``all_reduce``) as
``c10d.allreduce_``.  :class:`CollectiveCounter`, a ``TorchDispatchMode``,
sees each one as it is dispatched and reads its tensors' shapes, so it
works on fake tensors over a fake process group as well as on a real
step.  The trace is dynamic: a layer loop or a microbatch loop issues
its collectives once per trip, so no trip count has to be recovered, as
the reference must for a ``while`` loop.

Payload convention (per device), the reference's:
  all-gather          : result bytes x (g - 1) / g (what arrives)
  reduce-scatter      : result bytes x (g - 1) (what leaves)
  all-reduce          : 2 x operand bytes x (g - 1) / g (ring = RS + AG)
  all-to-all          : operand bytes
  collective-permute  : result bytes (no step of the port issues one)
where g is the group's size.  A group of one moves nothing.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name -> (kind, the argument whose tensors are the payload ("out" for
# the op's result), the argument that names the group): DTensor's
# functional collectives and the in-place sum of ``sharding/parallel.py``
_OPS: Dict[str, Tuple[str, str, str]] = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out",
                                                "group_size"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out",
                                               "group_size"),
    "_c10d_functional.all_reduce": ("all-reduce", "input", "group_name"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "input",
                                           "group_name"),
    "c10d.allreduce_": ("all-reduce", "tensors", "process_group"),
}


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _group_size(kind_arg: str, value: Any) -> int:
    if kind_arg == "group_size":
        return int(value)
    if kind_arg == "group_name":
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(value).size()
    from torch.distributed import ProcessGroup
    return ProcessGroup.unbox(value).size()     # a script object


def payload(kind: str, nbytes: float, g: int) -> float:
    """Per-device bytes of one collective (module docstring)."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(nbytes * (g - 1))
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    return float(nbytes)


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched inside it: ``calls`` holds one
    (kind, payload tensors' bytes, group size) per op, :meth:`bytes` the
    per-device sums."""

    def __init__(self):
        super().__init__()
        self.calls: List[Tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = _OPS.get(func._schema.name.replace("::", "."))
        if rule is not None:
            kind, data, group = rule
            named = {a.name: v for a, v in zip(func._schema.arguments, args)}
            named.update(kwargs)
            nbytes = _nbytes(out if data == "out" else named[data])
            self.calls.append((kind, nbytes, _group_size(group,
                                                         named[group])))
        return out

    def bytes(self) -> Dict[str, float]:
        """{kind: bytes per device} for every kind, plus ``"total"``."""
        totals = {k: 0.0 for k in COLLECTIVES}
        for kind, nbytes, g in self.calls:
            totals[kind] += payload(kind, nbytes, g)
        totals["total"] = sum(totals.values())
        return totals


def collective_bytes_per_device(fn: Callable, *args, **kwargs
                                ) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` and sum the per-device payload bytes of
    the collectives it issues: ``{"all-reduce": bytes, ..., "total":
    bytes}``, the reference's keys."""
    with CollectiveCounter() as counter:
        fn(*args, **kwargs)
    return counter.bytes()
