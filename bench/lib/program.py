"""The program's own spans in a traced slice, and the device operations
each launched.

The program (``repro_torch.tracing``) opens a profiler range named
``repro.<name> k=v ...`` around each piece of its work while a profiler
records: a training step and its phases, each layer and sublayer, the
data pipeline's wait.  ``trace.from_kineto`` lists each such range as a
``cpu`` event on the thread that opened it; a range of the program's
scope has no device-side copy, so busy time and the top device
operations count kernels only, and ``Trace.host_at`` names an idle gap
by the innermost range the host was in.

A device operation belongs to the innermost ``repro.`` range open on the
thread that launched it, at the launch (found through the launch's
correlation id, as ``Trace.span_of`` finds a benchmark span).  On a card
the backward pass runs on autograd's device thread, and with it remat's
second forward: a recomputed layer's kernels go to the ``recompute=1``
ranges opened there, a plain backward kernel to none.  An instance is
whole when its host range and every device operation it launched lie
inside the slice.  Where the trace holds no ``repro.`` range (a program
without the spans) every reader finds nothing and reads None.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

from .trace import Event, Trace, parse_span

PREFIX = "repro."       # the program's spans (repro_torch.tracing.PREFIX)


class Instance(NamedTuple):
    span: Event                 # the range, on the host's clock
    attrs: Dict[str, str]       # its attributes, as strings
    ops: List[Event]            # the device operations it launched

    @property
    def host_s(self) -> float:
        return self.span.end - self.span.start

    @property
    def device_s(self) -> float:
        """Summed device time of the operations it launched."""
        return sum(e.end - e.start for e in self.ops)


def instances(tr: Trace) -> Dict[str, List[Instance]]:
    """Every ``repro.`` range that overlaps the slice, by name (without
    its attributes; ``repro.model.attention``), each with the device
    operations whose launch it was the innermost range of."""
    ranges = [e for e in tr.cpu if e.kind == "cpu"
              and e.name.startswith(PREFIX)]
    ops: Dict[Event, List[Event]] = {s: [] for s in ranges}
    by_thread: Dict[int, List[Event]] = defaultdict(list)
    for s in ranges:
        by_thread[s.thread].append(s)
    launch_of = {e.corr: e for e in tr.cpu
                 if e.kind == "runtime" and e.corr}
    launches: Dict[int, List] = defaultdict(list)
    for e in tr.device:
        launch = launch_of.get(e.corr)
        if launch is not None and launch.thread in by_thread:
            launches[launch.thread].append((launch.start, e))
    for thread, spans in by_thread.items():
        spans.sort(key=lambda s: (s.start, -s.end))
        for s, op in _innermost(spans, sorted(launches[thread],
                                              key=lambda x: x[0])):
            ops[s].append(op)
    out: Dict[str, List[Instance]] = defaultdict(list)
    for s in ranges:
        head, attrs = parse_span(s.name)
        out[head].append(Instance(s, attrs, ops[s]))
    return out


def _innermost(spans: List[Event], launches: List):
    """(range, op) for each (launch time, op) that some range of one
    thread holds: the innermost, by a sweep (ranges of one thread nest)."""
    stack: List[Event] = []
    j = 0
    for t, op in launches:
        while j < len(spans) and spans[j].start <= t:
            while stack and stack[-1].end < spans[j].start:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1].end < t:
            stack.pop()
        if stack:
            yield stack[-1], op


def whole(tr: Trace, name: str) -> List[Instance]:
    """The instances of range ``repro.<name>`` whose host range and
    device operations all lie inside the slice."""
    def inside(e: Event) -> bool:
        return tr.start <= e.start and e.end <= tr.end
    return [i for i in instances(tr).get(PREFIX + name, [])
            if inside(i.span) and all(inside(e) for e in i.ops)]


def median_ms(run, name: str, device: bool) -> Optional[float]:
    """Median over the whole instances of ``repro.<name>`` in the traced
    slice of the device time each launched (`device`) or of its host
    duration, in ms; None with no trace or no whole instance."""
    if run.trace is None:
        return None
    got = [i.device_s if device else i.host_s
           for i in whole(run.trace, name)]
    return 1e3 * statistics.median(got) if got else None
