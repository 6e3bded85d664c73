"""Roofline terms and the Session placer's stage-cost model (mirrors
``repro.roofline``; the HLO collective counter is not ported yet)."""
from .placement import StageCost, est_runtime, estimate_error  # noqa: F401
from .terms import HW, roofline_terms  # noqa: F401
