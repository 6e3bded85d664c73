"""Roofline cost descriptors for Session stage placement.

The placer (core/session.py) prices *bytes* — locality and movement —
but a score that is blind to compute speed sends a compute-bound HPC
stage and a memory-bound analytics stage to the same pilot whenever
their input bytes match.  This module closes that gap: a stage may
carry a :class:`StageCost` (global FLOPs + HBM traffic), each pilot
advertises per-chip peak FLOP/s and HBM bandwidth in its description,
and :func:`est_runtime` turns the pair into the roofline time
``max(compute_s, memory_s)`` on that pilot — the ``− est_runtime`` term
of the placement objective.

This is the YARN node-label / speculative-execution-estimate analogue:
the runtime knows how fast each partition is and routes work by
*predicted completion time*, not just by where the bytes sit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class StageCost:
    """Global cost of one stage execution (whole stage, all chips):
    the raw numbers ``flops`` and ``hbm_bytes``."""
    flops: float = 0.0          # total FLOPs for one execution
    hbm_bytes: float = 0.0      # total HBM traffic for one execution

    def __post_init__(self):
        if self.flops < 0 or self.hbm_bytes < 0:
            raise ValueError(f"StageCost terms must be >= 0, got "
                             f"flops={self.flops} hbm_bytes={self.hbm_bytes}")

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOP/byte) — the roofline x-axis."""
        return self.flops / max(self.hbm_bytes, 1.0)


def est_runtime(cost: StageCost, *, n_chips: int, peak_flops: float,
                hbm_bw: float) -> Dict[str, float]:
    """Roofline runtime of ``cost`` spread over ``n_chips`` of a pilot
    advertising ``peak_flops`` FLOP/s and ``hbm_bw`` B/s per chip.

    Returns the terms the placer records: ``compute_s``, ``memory_s``,
    the binding resource ``bound``, and ``est_s = max(compute, memory)``.
    """
    n = max(n_chips, 1)
    compute_s = cost.flops / (n * max(peak_flops, 1.0))
    memory_s = cost.hbm_bytes / (n * max(hbm_bw, 1.0))
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "est_s": max(compute_s, memory_s),
    }


def estimate_error(est_s: float, actual_s: float) -> Optional[float]:
    """actual/estimate ratio (>1: the model was optimistic); None when
    the estimate is degenerate."""
    if est_s <= 0.0:
        return None
    return actual_s / est_s
