"""Arithmetic the metric readers share: a kernel's share of its roofline
from the trace, and the idle share of the device."""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional


def roofline(run, names: Iterable[str], counted: str,
             bound_of: Callable[[Dict[str, str]], Optional[float]]
             ) -> Optional[float]:
    """Percent: the least time of the launches of kernel `counted` over
    the device time of every kernel in `names` (the kernel's parts),
    counting only launches for which `bound_of` (the attributes of the
    benchmark span that launched them, {} if none) gives a bound.  None
    when the trace holds none of them."""
    tr = run.trace
    if tr is None:
        return None
    need = spent = 0.0
    for name in names:
        for e, attrs in tr.kernels(name):
            b = bound_of(attrs)
            if b is None:
                continue
            spent += e.end - e.start
            if name == counted:
                need += b
    if spent <= 0 or need <= 0:
        return None
    return 100.0 * need / spent


def idle(run) -> Optional[float]:
    """Percent of the traced slice in which no operation ran on the
    device (one minus the union of device intervals over the slice)."""
    tr = run.trace
    share = tr.idle_share() if tr is not None else None
    return None if share is None else 100.0 * share
