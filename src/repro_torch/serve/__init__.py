"""Serving: the prefill and decode steps, the continuous-batching engine,
KV pages on the DataPlane and the disaggregated router."""
from .engine import (AdmissionControl, ModelBackend,  # noqa: F401
                     PrefillResult, Request, ServeEngine, SimBackend,
                     StaticBudgetAdmission)
from .kv_pages import KVLease, KVPageManager, kv_cache_rates  # noqa: F401
from .router import DrfAdmission, EngineHandle, ServeRouter  # noqa: F401
from .step import make_decode_step, make_prefill_step  # noqa: F401
