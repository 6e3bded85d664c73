"""Serving steps (the engine, KV pages and router come later)."""
from .step import make_decode_step, make_prefill_step  # noqa: F401
