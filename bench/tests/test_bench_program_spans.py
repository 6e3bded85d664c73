"""The program's spans in a traced slice (``lib/program.py``) and the five
readers of them, on synthetic events: each reader's value by hand, with
instances cut by the slice's edges left out and a recomputed layer's
kernels launched from autograd's thread; the metrics read before the
spans reading the same with the program's ranges among the profiler's
events (``from_kineto`` keeps them on the host: the program's ranges
have no device-side copy); and an idle gap named by the range the host
was in."""
from __future__ import annotations

import types

import pytest

from bench_support import BENCH, ROOT, load

from lib import harness, program
from lib.trace import Event, Trace, from_kineto

CELL = "hymba-1.5b.train-8x2048"
NEW = ["data_wait_ms.train", "optimizer_ms.train", "recompute_share.train",
       "attention_ms.train", "mamba_ms.train"]
MAIN, AUTOGRAD, DATA = 2, 4, 6


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               f"t_spans_{name.replace('.', '_')}")


def fake(trace=None, **kw):
    return types.SimpleNamespace(**{"trace": trace, "config": {},
                                    "records": {}, **kw})


def launched(name, corr, thread, t_launch, start, end):
    """A launch on `thread` at `t_launch` and the device operation it
    started, running [start, end]."""
    return [Event("cudaLaunchKernel", "runtime", t_launch, t_launch + 0.001,
                  thread, corr),
            Event(name, "device", start, end, 0, corr)]


def cpu(name, start, end, thread=MAIN):
    return Event(name, "cpu", start, end, thread, 0)


def events():
    """A slice [1, 10]: the step's thread, autograd's and the data
    pipeline's; every number below is checked by hand in the tests."""
    return [
        Event("bench.slice", "span", 1.0, 10.0, 1, 0),
        # data waits: 2 ms and 4 ms whole; two cut by the edges
        cpu("repro.data.wait", 0.99, 1.01),
        cpu("repro.data.wait", 1.10, 1.102),
        cpu("repro.data.wait", 6.00, 6.004),
        cpu("repro.data.wait", 9.99, 10.05),
        # an attention whose host range began before the slice
        cpu("repro.model.attention recompute=0", 0.98, 1.05),
        *launched("elementwise", 10, MAIN, 1.01, 1.02, 1.08),
        # the forward: attention 0.15 s, Mamba 0.03 s, the rest to forward
        cpu("repro.train.forward", 1.2, 2.0),
        cpu("repro.model.attention recompute=0", 1.3, 1.4),
        *launched("elementwise", 11, MAIN, 1.31, 1.32, 1.42),
        *launched("softmax", 12, MAIN, 1.35, 1.42, 1.47),
        cpu("repro.model.mamba recompute=0", 1.5, 1.6),
        *launched("mamba_scan_kernel", 13, MAIN, 1.51, 1.52, 1.55),
        *launched("embedding", 14, MAIN, 1.9, 1.9, 1.95),
        # the prefetch thread's host-to-device copy
        cpu("repro.data.batch step=3", 2.0, 2.1, DATA),
        *launched("Memcpy HtoD", 41, DATA, 2.05, 2.06, 2.07),
        # backward: open on the step's thread, run on autograd's; the
        # recompute of layer 0 (attention 0.2 s, Mamba 0.05 s, the block's
        # own 0.05 s) and a plain backward kernel outside any span there
        cpu("repro.train.backward", 3.0, 5.0),
        cpu("repro.model.block layer=0 recompute=1", 3.2, 3.6, AUTOGRAD),
        cpu("repro.model.attention recompute=1", 3.25, 3.4, AUTOGRAD),
        *launched("elementwise", 21, AUTOGRAD, 3.26, 3.3, 3.5),
        cpu("repro.model.mamba recompute=1", 3.42, 3.5, AUTOGRAD),
        *launched("mamba_scan_kernel", 22, AUTOGRAD, 3.43, 3.5, 3.55),
        *launched("rmsnorm", 23, AUTOGRAD, 3.55, 3.55, 3.6),
        *launched("mamba_ssm_bwd_kernel", 24, AUTOGRAD, 3.7, 3.7, 4.2),
        # optimizers: 0.15 s and 0.2 s whole; the last runs past the end
        cpu("repro.train.optimizer", 5.5, 5.6),
        *launched("adamw", 31, MAIN, 5.51, 5.6, 5.7),
        *launched("adamw", 32, MAIN, 5.52, 5.7, 5.75),
        cpu("repro.train.optimizer", 7.0, 7.1),
        *launched("adamw", 33, MAIN, 7.01, 7.1, 7.3),
        cpu("repro.train.optimizer", 9.5, 9.6),
        *launched("adamw", 34, MAIN, 9.55, 9.9, 10.2),
    ]


# busy: the union of device intervals inside [1, 10]
BUSY = (0.06 + 0.15 + 0.03 + 0.05 + 0.01 + 0.3 + 0.5 + 0.15 + 0.2 + 0.1)


def test_ops_go_to_the_innermost_span_on_the_launching_thread():
    tr = Trace(events())
    assert tr.busy_s() == pytest.approx(BUSY)
    got = {(h, i.span.start): sorted(e.corr for e in i.ops)
           for h, insts in program.instances(tr).items() for i in insts}
    assert got[("repro.train.forward", 1.2)] == [14]
    assert got[("repro.model.attention", 1.3)] == [11, 12]
    assert got[("repro.model.attention", 3.25)] == [21]
    assert got[("repro.model.block", 3.2)] == [23]
    assert got[("repro.data.batch", 2.0)] == [41]
    # autograd's plain backward kernel is no span's: the step's thread
    # holds repro.train.backward open, but did not launch it
    assert got[("repro.train.backward", 3.0)] == []
    assert 24 not in {c for ops in got.values() for c in ops}


def test_whole_leaves_out_instances_cut_by_the_slice():
    tr = Trace(events())
    assert [i.span.start for i in program.whole(tr, "data.wait")] == \
        [1.10, 6.00]
    assert [i.span.start for i in program.whole(tr, "train.optimizer")] \
        == [5.5, 7.0]
    assert [i.span.start for i in program.whole(tr, "model.attention")] \
        == [1.3, 3.25]


@pytest.mark.parametrize("name, want", [
    ("data_wait_ms.train", 3.0),                  # median of 2 and 4 ms
    ("optimizer_ms.train", 175.0),                # median of 150 and 200
    ("recompute_share.train", 100 * 0.3 / BUSY),  # [3.3, 3.6] of busy
    ("attention_ms.train", 175.0),                # forward 150, recompute 200
    ("mamba_ms.train", 40.0),                     # forward 30, recompute 50
])
def test_each_reader_gives_its_hand_computed_value(name, want):
    assert reader(name).read(fake(Trace(events()))) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_the_program_spans(name):
    """The parent's program opens no repro. range: None, no error."""
    bare = [e for e in events() if not e.name.startswith("repro.")]
    assert reader(name).read(fake(Trace(bare))) is None
    assert reader(name).read(fake(None)) is None


class _KinetoEvent:
    """The part of a ``torch.profiler`` kineto event that
    ``from_kineto`` reads."""

    def __init__(self, name, start, end, thread, corr, device=False):
        self._v = (name, int(start * 1e9), int((end - start) * 1e9),
                   "DeviceType.CUDA" if device else "DeviceType.CPU",
                   thread, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def _prof(evs):
    res = types.SimpleNamespace(events=lambda: evs)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


def _kineto(with_program: bool):
    """A step's kineto events, and with the program's ranges: host-side
    events of the threads that opened them (a range of the program's
    scope, unlike a benchmark span, has no device-side copy)."""
    K = _KinetoEvent
    evs = [K("bench.slice", 0.0, 10.0, 1, 0),
           K("bench.slice", 0.5, 9.5, 0, 0, device=True),
           K("aten::mm", 8.0, 9.5, MAIN, 0)]
    kernels = [("mamba_scan_kernel", 51, 1.0, 1.5, 2.0),
               ("mamba_ssm_bwd_kernel", 52, 3.0, 3.5, 4.5),
               ("mamba_ssm_bwd_sum_kernel", 53, 3.1, 4.5, 4.7),
               ("elementwise", 54, 6.0, 6.2, 7.0)]
    for name, corr, t, s, e in kernels:
        evs += [K("cudaLaunchKernel", t, t + 0.01, MAIN, corr),
                K(name, s, e, 0, corr, device=True)]
    if with_program:
        for name, s, e, thread in [
                ("repro.train.step step=4", 0.2, 9.8, MAIN),
                ("repro.model.mamba recompute=0", 0.9, 1.2, MAIN),
                ("repro.train.backward", 2.9, 5.0, MAIN),
                ("repro.model.block layer=3 recompute=1", 3.0, 3.2, 4),
                ("repro.train.optimizer", 5.9, 6.1, MAIN)]:
            evs.append(K(name, s, e, thread, 0))
    return evs


@pytest.mark.parametrize("metric", ["k3_roofline.train",
                                    "ssm_bwd_roofline.train",
                                    "device_idle.train"])
def test_metrics_before_the_spans_read_the_same_with_them(metric):
    cfg = {"ssm_expand": 2, "d_model": 1600, "ssm_d_state": 16}

    def read(with_program):
        tr = Trace(from_kineto(_prof(_kineto(with_program))))
        return reader(metric).read(fake(tr, config=cfg, records={
            "microbatch": (4, 2048)})), tr

    (bare, tb), (spanned, ts) = read(False), read(True)
    assert bare is not None and spanned == pytest.approx(bare)
    assert ts.device == tb.device
    assert ts.device_ops() == tb.device_ops()
    assert ts.busy_s() == pytest.approx(2.5)
    # the ranges stay on the host, as cpu events of their thread
    assert {e.name.split(" ")[0] for e in ts.cpu if e.kind == "cpu"} >= {
        "repro.train.step", "repro.train.backward"}


def test_an_idle_gap_with_only_a_program_range_open_is_named_by_it():
    gaps = dict((round(b, 6), a) for a, b in Trace(events()).idle_gaps())
    assert gaps[1.4] == "repro.train.backward"        # [4.2, 5.6]
    assert gaps[2.6] == "no host event"               # [7.3, 9.9]


SPEC = load(ROOT / "BENCHMARK.json")
PERF = (ROOT / "PERF.md").read_text()


@pytest.mark.parametrize("name", NEW)
def test_new_entries_read_the_program_spans_in_the_train_cell(name):
    entry, = [m for m in SPEC["per_layer"] if m["name"] == name]
    assert SPEC["per_layer"][-len(NEW):][NEW.index(name)] is entry
    assert entry["source"] == "program_span"
    assert entry["moves"] == "train_tokens_per_s"
    assert entry["workloads"] == [CELL]
    mod = reader(name)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["better"], entry["source"], entry["layer"],
        entry["moves"])
    assert f"| {entry['layer']} (" in PERF        # PERF.md's list of layers
