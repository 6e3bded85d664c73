"""Named spans of the program's work, as ranges of ``torch.profiler``.

``span(name, **attrs)`` marks a piece of work (a training step, its
forward, backward and optimizer, each model layer and sublayer, the data
pipeline's wait).  While a ``torch.profiler`` session is active it opens
a profiler range named ``repro.<name> k=v ...``
(``repro.model.block layer=3 recompute=0``); while none is, it reads one
flag and returns a shared null context, with no name formatted and no
range opened, so the spans cost nothing to leave in.

A range is a function-scope ``RecordFunction`` (``_RecordFunctionFast``,
the range PyTorch's compiler emits), not ``record_function``'s
user-scope one: the profiler records it like any op, on the thread that
opens it, but makes no device-side copy of it (a user annotation gets a
``gpu_user_annotation`` over the kernels it launched, which a reader of
the device's busy time would count as work), and it does not go through
the dispatcher, so a selective-checkpoint policy never sees it.

Because the spans are the profiler's own ranges they lie on the clock of
its device trace (CUPTI places kernels on the same host clock), and each
kernel is tied to the span that launched it through its launch's
correlation id and thread: in the profiler's trace
(``prof.export_chrome_trace(path)``) a kernel's launch sits under the
innermost span open on the launching thread, and an idle stretch of the
device under the span the host was in.  That trace is what one reads;
this module keeps no buffer and exports nothing.

Each span is a plain range on the thread that opens it, so its parent is
the range that encloses it there.  A step's spans nest under
``repro.train.step step=<n>``.  The backward pass runs on autograd's
device thread on a card, and with it the forward that remat runs again
inside backward: ``forward_span`` marks that second pass ``recompute=1``.

Like ``util``, it imports nothing of the port.
"""
from __future__ import annotations

import contextlib
from typing import ContextManager

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = "repro."
_NULL = contextlib.nullcontext()


def span(name: str, **attrs) -> ContextManager:
    """A range named ``repro.<name> k=v ...`` while the profiler records,
    else the shared null context.  The flag is the profiler module's, read
    each call: set on start and cleared on stop, for every thread."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _RecordFunctionFast(
        " ".join([PREFIX + name] + [f"{k}={v}" for k, v in attrs.items()]))


def forward_span(name: str, **attrs) -> ContextManager:
    """``span`` of a piece of the model's forward, with ``recompute=1``
    where it runs again inside backward (remat's second forward: autograd
    has a graph task running on this thread) and ``recompute=0`` where
    not."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return span(name, **attrs,
                recompute=int(torch._C._current_graph_task_id() >= 0))
