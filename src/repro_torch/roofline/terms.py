"""Roofline term computation for NVIDIA H100 targets."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU data sheet, dense
    rates without sparsity, at the full 700 W power limit)."""
    peak_flops: float = 989e12     # bf16 tensor-core FLOP/s per card
    hbm_bw: float = 3.35e12        # HBM3 B/s per card
    # NVLink 4: 900 GB/s per card counted both ways; one direction's
    # 450 GB/s is what a one-way transfer of collective bytes can use
    ici_bw: float = 450e9          # B/s per direction


def ssm_scan_terms(B: int, S: int, di: int, st: int):
    """The selective scan's two FLOP terms: the associative scan (~3x
    the sequential 5 an element) and the C readout.  Shared by
    ``analytic._ssm_flops`` and the scan kernels' FLOP formula, so the
    two count the scan alike by construction."""
    return 3 * 5 * B * S * di * st, 2 * B * S * di * st


def roofline_terms(*, flops_global: float, hbm_bytes_global: float,
                   collective_bytes_per_device: float, n_chips: int,
                   model_flops: float, hw: HW = HW()) -> Dict[str, float]:
    compute_s = flops_global / (n_chips * hw.peak_flops)
    memory_s = hbm_bytes_global / (n_chips * hw.hbm_bw)
    collective_s = collective_bytes_per_device / hw.ici_bw
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])
    step_s = max(compute_s, memory_s, collective_s)
    ideal_s = model_flops / (n_chips * hw.peak_flops)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant[0],
        "model_flops": model_flops,
        "useful_flop_ratio": model_flops / max(flops_global, 1.0),
        "roofline_fraction": ideal_s / max(step_s, 1e-12),
        "step_time_lower_bound_s": step_s,
    }
