"""The device trace of a bounded slice of the window, and what is read
from it.

``Slice`` runs ``torch.profiler`` (CPU and CUDA activities) from one
thread over [start, end] while the traffic runs on others.  The events
become plain ``Event`` tuples, so the reductions below (busy time as a
union of device intervals, the top device operations, the longest idle
gaps by what the host was doing, and the kernels by the benchmark span
that launched them) run on synthetic events in the CPU tests too.

A benchmark span is a ``torch.profiler.record_function`` whose name
starts with ``bench.``; its attributes ride in the name
(``bench.prefill bucket=2048 tokens=1500``).  A device operation belongs
to the innermost span that was open on the thread that launched it
(found through the launch's correlation id).  Where the trace gives the
launch no thread of the spans' numbering (a kernel launched from a
library of its own), the span open at the launch's time on any thread
stands, if all spans open then agree.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

from . import stats

SPAN_PREFIX = "bench."
SLICE_NAME = "bench.slice"
TOP = 10


class Event(NamedTuple):
    name: str
    kind: str          # "device", "runtime", "span" or "cpu"
    start: float       # seconds, the trace's clock
    end: float
    thread: int
    corr: int


def parse_span(name: str) -> Tuple[str, Dict[str, str]]:
    """('bench.prefill', {'bucket': '2048'}) of a span's name."""
    head, *rest = name.split(" ")
    return head, dict(kv.split("=", 1) for kv in rest if "=" in kv)


def span_name(name: str, **attrs) -> str:
    return " ".join([name] + [f"{k}={v}" for k, v in attrs.items()])


class Trace:
    """The events of one traced slice."""

    def __init__(self, events: List[Event]):
        sl = [e for e in events if e.kind == "span" and e.name == SLICE_NAME]
        if sl:
            self.start, self.end = sl[0].start, sl[0].end
        else:
            self.start = min((e.start for e in events), default=0.0)
            self.end = max((e.end for e in events), default=0.0)
        inside = [e for e in events
                  if e.end > self.start and e.start < self.end]
        self.device = [e for e in inside if e.kind == "device"]
        self.cpu = [e for e in inside if e.kind in ("cpu", "runtime")]
        self.spans = [e for e in inside
                      if e.kind == "span" and e.name != SLICE_NAME]
        runtime = {e.corr: e for e in events
                   if e.kind == "runtime" and e.corr}
        by_thread: Dict[int, List[Event]] = defaultdict(list)
        for e in events:
            if e.kind == "span" and e.name != SLICE_NAME:
                by_thread[e.thread].append(e)
        self._spans_of = {}
        for t, v in by_thread.items():
            v.sort(key=lambda e: e.start)
            self._spans_of[t] = (v, [e.start for e in v])
        self._launch = runtime

    # ------------------------------------------------------------ shares
    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """Seconds of the slice in which some operation ran on the device:
        the union of their intervals, not their sum."""
        return stats.covered(((e.start, e.end) for e in self.device),
                             self.start, self.end)

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or not self.device:
            return None
        return 1.0 - self.busy_s() / self.window_s

    # ------------------------------------------------------- attribution
    def span_of(self, e: Event) -> Optional[Event]:
        """The innermost benchmark span open when device operation `e`
        was launched: on the launching thread where the trace names it;
        else the span open at that time on any thread, if the spans open
        then agree (else None: the launch is not told apart)."""
        launch = self._launch.get(e.corr)
        if launch is None:
            return None
        spans, starts = self._spans_of.get(launch.thread, ([], []))
        # the latest-started span still open is the innermost
        for j in range(bisect.bisect_right(starts, launch.start) - 1, -1, -1):
            if spans[j].end >= launch.start:
                return spans[j]
        open_ = [s for s in self.spans if s.start <= launch.start <= s.end]
        if open_ and len({s.name for s in open_}) == 1:
            return max(open_, key=lambda s: s.start)
        return None

    def kernels(self, contains: str) -> List[Tuple[Event, Dict[str, str]]]:
        """Device operations whose name contains `contains`, each with
        the attributes of the span that launched it (name under '')."""
        out = []
        for e in self.device:
            if contains in e.name:
                s = self.span_of(e)
                attrs: Dict[str, str] = {}
                if s is not None:
                    head, attrs = parse_span(s.name)
                    attrs = {"": head, **attrs}
                out.append((e, attrs))
        return out

    # --------------------------------------------------------- breakdown
    def device_ops(self) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for e in self.device:
            tot[e.name[:160]] += e.end - e.start
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def host_at(self, t: float) -> str:
        """What the host was doing at time t: the innermost benchmark span
        open on any thread and the innermost CPU operation."""
        def innermost(evs):
            on = [e for e in evs if e.start <= t <= e.end]
            return min(on, key=lambda e: e.end - e.start) if on else None
        s, c = innermost(self.spans), innermost(self.cpu)
        parts = []
        if s is not None:
            parts.append(parse_span(s.name)[0])
        if c is not None:
            parts.append(c.name[:80])
        return " / ".join(parts) or "no host event"

    def idle_gaps(self) -> List[List]:
        gaps = stats.gaps(((e.start, e.end) for e in self.device),
                          self.start, self.end)
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_at(0.5 * (a + b)), b - a] for a, b in gaps[:TOP]]


def from_kineto(prof) -> List[Event]:
    """Plain events of a finished ``torch.profiler.profile``."""
    out: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() * 1e-9
        end = s + e.duration_ns() * 1e-9
        on_device = str(e.device_type()).split(".")[-1] == "CUDA"
        if name.startswith(SPAN_PREFIX):
            if on_device:       # the device-side copy of a span: no work
                continue
            kind = "span"
        elif on_device:
            kind = "device"
        elif name.startswith("cu") and e.correlation_id():
            kind = "runtime"    # a CUDA runtime or driver call
        else:
            kind = "cpu"
        out.append(Event(name, kind, s, end, e.start_thread_id(),
                         e.correlation_id()))
    return out


class Slice:
    """Profile `length` seconds from monotonic time `start` (or until
    `stop`), from the calling thread; ``trace`` holds the result."""

    def __init__(self):
        self.trace: Optional[Trace] = None

    def run(self, start: float, length: float, stop: threading.Event
            ) -> None:
        import torch
        from torch.profiler import record_function
        if not _wait_until(start, stop):
            return
        prof = _profiler()
        prof.start()
        rf = record_function(SLICE_NAME)
        rf.__enter__()
        try:
            _wait_until(time.monotonic() + length, stop)
            torch.cuda.synchronize()
        finally:
            rf.__exit__(None, None, None)
            prof.stop()
        self.trace = Trace(from_kineto(prof))


def warm_up() -> None:
    """Start and stop the profiler once, outside the window: its first
    start takes seconds (CUPTI's set-up)."""
    import torch
    prof = _profiler()
    prof.start()
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    prof.stop()


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_all_threads())


def _all_threads():
    """Record the CPU side of every thread, not only the one that starts
    the profiler: the traffic runs on threads of its own."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:           # a torch without the option
        return _ExperimentalConfig()


def _wait_until(t: float, stop: threading.Event) -> bool:
    """Sleep until monotonic time t; False if `stop` came first."""
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return True
        if stop.wait(min(left, 0.05)):
            return False
