"""The port's spans (``repro_torch.tracing``) in a training step, on the
CPU.

A tiny Hymba (2 layers: one full-attention, one windowed segment) trains
one step of 2 microbatches with remat on a one-device ``Trainer`` under
``torch.profiler`` (every thread recorded, as the benchmark records
them).  Each span of the step is recorded with its attributes and
nested as the module says: the model's ranges inside
``repro.train.forward`` in the forward pass, and again, marked
``recompute=1``, inside ``repro.train.backward`` (on the CPU autograd
runs the backward pass on the calling thread; on a card the recompute
runs on autograd's device thread, which the benchmark's tests cover).
The ranges are of the program's scope, not user annotations, so the
profiler makes no device-side copy of them.  With the profiler off no
range is entered, and the step's loss, gradients and new state are bit
for bit those of a profiled step.
"""
import contextlib
import dataclasses
import threading
from collections import Counter

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs.hymba_1_5b import SMOKE_CONFIG
from repro_torch.core import DeviceGrid
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer
from repro_torch.train.step import (make_train_state, make_train_step,
                                    value_and_grad)
from repro_torch.train.trainer import Trainer
from repro_torch.util import tree_leaves

CPU = torch.device("cpu")
CFG = dataclasses.replace(SMOKE_CONFIG, n_layers=2, full_attn_layers=(0,))
N_MB = 2


def _profiler():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _ranges(prof):
    """(name, attrs, thread, start, end) of each ``repro.`` range."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            assert not e.is_user_annotation(), e.name()
            head, *rest = e.name().split(" ")
            attrs = dict(kv.split("=", 1) for kv in rest)
            out.append((head, attrs, e.start_thread_id(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


def _inside(inner, outer):
    return (inner[2] == outer[2] and outer[3] <= inner[3]
            and inner[4] <= outer[4])


@pytest.fixture(scope="module")
def step_ranges():
    """The ranges of one profiled Trainer step."""
    tr = Trainer(CFG, DeviceGrid([CPU]), global_batch=4, seq=32,
                 n_microbatches=N_MB, seed=1)
    with _profiler() as prof:
        tr.run(1, log_every=0)
    assert not tracing._profiler._is_profiler_enabled
    return _ranges(prof)


def _named(ranges, head, **attrs):
    return [r for r in ranges if r[0] == "repro." + head
            and all(r[1].get(k) == str(v) for k, v in attrs.items())]


def test_each_span_is_recorded_with_its_attributes(step_ranges):
    heads = Counter(r[0] for r in step_ranges)
    n_layers = CFG.n_layers
    assert heads["repro.train.step"] == 1
    assert _named(step_ranges, "train.step", step=0)
    assert heads["repro.train.sync"] == 1
    assert heads["repro.data.wait"] == 1
    assert _named(step_ranges, "data.batch", step=0)
    assert heads["repro.train.microbatch"] == N_MB
    for mb in range(N_MB):
        assert len(_named(step_ranges, "train.microbatch", mb=mb)) == 1
    assert heads["repro.train.forward"] == N_MB
    assert heads["repro.train.backward"] == N_MB
    assert heads["repro.train.accumulate"] == N_MB + 1   # and the 1/n
    assert heads["repro.train.optimizer"] == 1
    assert heads["repro.model.loss"] == N_MB
    for layer in range(n_layers):
        for rc in (0, 1):
            assert len(_named(step_ranges, "model.block", layer=layer,
                              recompute=rc)) == N_MB
    for sub in ("attention", "mamba", "mlp"):
        for rc in (0, 1):
            assert len(_named(step_ranges, f"model.{sub}",
                              recompute=rc)) == N_MB * n_layers
    assert not {h for h in heads
                if h.startswith("repro.model.")} - {
        "repro.model.block", "repro.model.attention", "repro.model.mamba",
        "repro.model.mlp", "repro.model.loss"}


def test_spans_nest_as_the_step_runs(step_ranges):
    step, = _named(step_ranges, "train.step")
    wait, = _named(step_ranges, "data.wait")
    assert wait[2] == step[2] and wait[4] <= step[3]   # before the step
    batch0, = _named(step_ranges, "data.batch", step=0)
    assert batch0[2] != step[2]                         # the prefetch thread
    for head in ("train.microbatch", "train.optimizer", "train.sync"):
        assert all(_inside(r, step) for r in _named(step_ranges, head))
    mbs = _named(step_ranges, "train.microbatch")
    for head in ("train.forward", "train.backward"):
        for m in mbs:
            assert len([r for r in _named(step_ranges, head)
                        if _inside(r, m)]) == 1
    acc = _named(step_ranges, "train.accumulate")
    assert all(_inside(r, step) for r in acc)
    # one a microbatch, and the 1/n scale after the last
    assert sum(any(_inside(r, m) for m in mbs) for r in acc) == N_MB
    fwd = _named(step_ranges, "train.forward")
    bwd = _named(step_ranges, "train.backward")
    model = [r for r in step_ranges if r[0].startswith("repro.model.")]
    for r in model:
        if r[1]["recompute"] == "0":
            assert any(_inside(r, f) for f in fwd), r
        else:
            assert any(_inside(r, b) for b in bwd), r
            assert not any(_inside(r, f) for f in fwd), r
    blocks = _named(step_ranges, "model.block")
    for sub in ("attention", "mamba", "mlp"):
        for r in _named(step_ranges, f"model.{sub}"):
            assert any(_inside(r, b) and b[1]["recompute"] == r[1][
                "recompute"] for b in blocks), r


def test_recompute_runs_once_per_layer_and_microbatch_in_backward(
        step_ranges):
    """Remat's second forward: each layer once per microbatch, inside
    that microbatch's backward, after the forward of every layer."""
    for mb in _named(step_ranges, "train.microbatch"):
        bwd, = [b for b in _named(step_ranges, "train.backward")
                if _inside(b, mb)]
        fwd, = [f for f in _named(step_ranges, "train.forward")
                if _inside(f, mb)]
        rec = [r for r in _named(step_ranges, "model.block", recompute=1)
               if _inside(r, bwd)]
        assert sorted(int(r[1]["layer"]) for r in rec) == \
            list(range(CFG.n_layers))
        assert min(r[3] for r in rec) >= fwd[4]


def _tiny_step():
    gen = torch.Generator().manual_seed(0)
    state = make_train_state(CFG, transformer.init_params(CFG, gen,
                                                          device=CPU))
    batch = TokenPipeline(CFG, batch=4, seq=32, seed=0,
                          device=CPU).batch_at(0)
    return state, batch, make_train_step(CFG, n_microbatches=N_MB)


class _Counting:
    entered: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered.append(self.name)

    def __exit__(self, *exc):
        return False


def test_no_range_is_opened_with_the_profiler_off(monkeypatch):
    monkeypatch.setattr(tracing, "_RecordFunctionFast", _Counting)
    monkeypatch.setattr(_Counting, "entered", [])
    state, batch, step = _tiny_step()
    assert tracing.span("x", a=1) is tracing.span("y")   # the shared null
    step(state, batch)
    assert _Counting.entered == []
    with _profiler():
        with tracing.span("x", a=1):
            pass
        step(state, batch)
    assert _Counting.entered[0] == "repro.x a=1"
    assert "repro.train.optimizer" in _Counting.entered


def test_step_is_bit_for_bit_the_same_with_the_profiler_on():
    def run(profiled):
        state, batch, step = _tiny_step()
        with (_profiler() if profiled else contextlib.nullcontext()):
            loss, grads = value_and_grad(
                lambda p: transformer.loss_fn(CFG, p, batch, remat=True),
                state["params"])
            new, metrics = step(state, batch)
        return [loss, *tree_leaves(grads), metrics["loss"],
                metrics["grad_norm"], *tree_leaves(new["params"]),
                *tree_leaves(new["opt"])]

    off, on = run(False), run(True)
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_span_flag_is_read_on_every_thread():
    """The profiler's flag is process-wide: a thread started before the
    profiler opens real ranges once it records."""
    seen = []
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait()
        seen.append(tracing.span("t") is not tracing.span("u"))
        done.set()

    th = threading.Thread(target=worker)
    th.start()
    with _profiler():
        go.set()
        done.wait(10)
    th.join()
    assert seen == [True]
