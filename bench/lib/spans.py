"""Spans the benchmark takes around its calls into the program: a name,
host start and end (``time.monotonic`` seconds) and attributes.  In a
traced run each span is also a ``record_function`` named as
``trace.span_name`` makes it, so the device operations it launches can
be traced back to it."""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, NamedTuple

from . import trace


class Span(NamedTuple):
    name: str
    start: float
    end: float
    attrs: Dict[str, Any]


class Spans:
    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.items: List[Span] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        rf = None
        if self.annotate:
            from torch.profiler import record_function
            rf = record_function(trace.span_name(name, **attrs))
            rf.__enter__()
        t0 = time.monotonic()
        try:
            yield attrs
        finally:
            t1 = time.monotonic()
            if rf is not None:
                rf.__exit__(None, None, None)
            with self._lock:
                self.items.append(Span(name, t0, t1, attrs))

    def named(self, name: str) -> List[Span]:
        return [s for s in self.items if s.name == name]
