"""Roofline terms, the Session placer's stage-cost model and the
collective-byte counter (mirrors ``repro.roofline``; the analytic cost
model is :mod:`repro_torch.roofline.analytic`, imported on its own since
it loads the model stack)."""
from .collectives import collective_bytes_per_device  # noqa: F401
from .placement import StageCost, est_runtime, estimate_error  # noqa: F401
from .terms import HW, roofline_terms  # noqa: F401
