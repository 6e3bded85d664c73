"""The metric arithmetic on synthetic timestamps and events: a rate over
the whole window, a 95th percentile over every request with misses
counted, the device's idle share from the union of intervals, and the
trace's attribution of kernels to the spans that launched them."""
from __future__ import annotations

import math
import types

import pytest

from bench_support import BENCH

from lib import bounds, harness, readers, stats
from lib.trace import Event, Trace


def reader(section, name):
    folder = "end_to_end" if section == "end_to_end" else "metrics"
    return harness.load_module(BENCH / folder / f"{name}.py",
                               f"t_{folder}_{name.replace('.', '_')}")


def fake(**kw):
    run = types.SimpleNamespace(window_start=100.0, window_end=110.0,
                                records={}, trace=None, config={},
                                spans=types.SimpleNamespace(named=lambda n: []))
    run.window_s = run.window_end - run.window_start
    run.__dict__.update(kw)
    return run


def test_rate_is_over_the_whole_window():
    steps = [{"t0": 100 + 2 * i, "t1": 102 + 2 * i, "tokens": 1000}
             for i in range(4)]
    run = fake(records={"steps": steps}, window_end=108.0)
    run.window_s = 8.0
    assert reader("end_to_end", "train_tokens_per_s").read(run) == 500.0
    fits = [{"result": 1}] * 30 + [{"error": "x"}] * 5
    run = fake(records={"fits": fits})
    assert reader("end_to_end", "kmeans_fits_per_s").read(run) == 3.0


def test_p95_counts_every_request_and_misses():
    reqs = [{"due": 0.0, "t_first": 0.1 * (i + 1), "t_done": 1.0,
             "n_out": 11} for i in range(19)]
    reqs.append({"due": 0.0, "t_first": None, "t_done": None, "n_out": 0})
    run = fake(records={"requests": reqs})
    # 20 requests: the 95th percentile is the 19th smallest, 1.9 s
    assert reader("end_to_end", "ttft_p95_ms").read(run) == pytest.approx(1900)
    tpot = reader("end_to_end", "tpot_p95_ms").read(run)
    assert tpot == pytest.approx(1e3 * (1.0 - 0.1) / 10)
    reqs[5].update(t_first=None, t_done=None, n_out=0)
    assert reader("end_to_end", "ttft_p95_ms").read(run) == math.inf


def test_percentile_nearest_rank():
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([1, 2, math.inf], 50) == 2


def test_quartile_spread_matches_statistics_quantiles():
    v = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    import statistics
    q = statistics.quantiles(v, n=4)
    assert stats.quartile_spread(v) == (q[2] - q[0]) / q[1]


def test_union_not_sum():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert stats.covered(iv, 0.0, 10.0) == 4.0
    assert stats.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert stats.covered(iv, 1.5, 5.5) == 2.0


def events():
    """A slice of 10 s: two threads' spans, overlapping kernels on two
    streams, runtime launches tying kernels to spans."""
    E = Event
    return [
        E("bench.slice", "span", 0.0, 10.0, 1, 0),
        E("bench.prefill bucket=2048 tokens=1500", "span", 1.0, 4.0, 2, 0),
        E("bench.step", "span", 5.0, 6.0, 2, 0),
        E("cudaLaunchKernel", "runtime", 1.5, 1.6, 2, 11),
        E("cudaLaunchKernel", "runtime", 5.1, 5.2, 2, 12),
        E("cudaLaunchKernel", "runtime", 7.0, 7.1, 3, 13),
        E("aten::mm", "cpu", 8.0, 9.5, 3, 0),
        E("mamba_scan_kernel", "device", 2.0, 3.0, 0, 11),
        E("gemm", "device", 2.5, 4.0, 0, 0),
        E("mamba_scan_kernel", "device", 5.5, 6.0, 0, 12),
        E("mamba_scan_kernel", "device", 7.5, 8.0, 0, 13),
    ]


def test_trace_busy_idle_and_breakdown():
    tr = Trace(events())
    assert tr.window_s == 10.0
    assert tr.busy_s() == pytest.approx(2.0 + 0.5 + 0.5)
    assert tr.idle_share() == pytest.approx(0.7)
    assert readers.idle(fake(trace=tr)) == pytest.approx(70.0)
    ops = dict(tr.device_ops())
    assert ops["mamba_scan_kernel"] == pytest.approx(2.0)
    gaps = tr.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([2.0, 2.0, 1.5, 1.5])
    assert gaps[0][0] == "bench.prefill"          # (0, 2): the prefill span
    assert gaps[1][0] == "aten::mm"               # (8, 10): a CPU op


def test_kernels_are_tied_to_the_span_that_launched_them():
    tr = Trace(events())
    got = [(e.start, a) for e, a in tr.kernels("mamba_scan_kernel")]
    assert got[0][1] == {"": "bench.prefill", "bucket": "2048",
                         "tokens": "1500"}
    assert got[1][1] == {"": "bench.step"}
    assert got[2][1] == {}


def test_launches_on_an_unnumbered_thread_take_the_span_open_then():
    E = Event
    base = [E("bench.slice", "span", 0.0, 10.0, 1, 0),
            E("bench.fit scenario=0", "span", 1.0, 3.0, 5, 0),
            E("bench.fit scenario=2", "span", 2.0, 4.0, 6, 0),
            E("cudaLaunchKernel", "runtime", 1.5, 1.6, 99, 21),
            E("cudaLaunchKernel", "runtime", 2.5, 2.6, 99, 22),
            E("k", "device", 1.7, 1.8, 0, 21),
            E("k", "device", 2.7, 2.8, 0, 22)]
    got = [a for _, a in Trace(base).kernels("k")]
    assert got[0] == {"": "bench.fit", "scenario": "0"}
    assert got[1] == {}              # two fits open: not told apart


def test_roofline_counts_bounds_of_attributed_launches_only():
    run = fake(trace=Trace(events()))
    # only the prefill's launch has a bound: 0.25 s of need over 1.0 s
    share = readers.roofline(
        run, ("mamba_scan_kernel",), "mamba_scan_kernel",
        lambda a: 0.25 if a.get("") == "bench.prefill" else None)
    assert share == pytest.approx(25.0)
    assert readers.roofline(fake(), ("x",), "x", lambda a: 1.0) is None


def test_k3_serve_reader_uses_the_bucket():
    cfg = {"ssm_expand": 2, "d_model": 1600, "ssm_d_state": 16}
    run = fake(trace=Trace(events()), config=cfg)
    got = reader("per_layer", "k3_roofline.serve").read(run)
    want = 100 * bounds.scan_bound(1, 2048, 3200, 16)["seconds"] / 1.0
    assert got == pytest.approx(want)


def test_decode_and_prefill_readers_take_window_spans_only():
    from lib.spans import Span
    spans = [Span("bench.step", 99.0, 99.5, {}),
             Span("bench.step", 101.0, 101.1, {}),
             Span("bench.step", 102.0, 102.3, {}),
             Span("bench.prefill", 103.0, 104.0, {"tokens": 1000,
                                                  "bucket": 1024})]
    ns = types.SimpleNamespace(
        named=lambda n: [s for s in spans if s.name == n])
    cfg = {"d_model": 64, "n_heads": 4, "n_kv_heads": 1, "head_dim": 16,
           "ssm_expand": 2, "ssm_d_state": 4, "ssm_d_conv": 4, "d_ff": 128,
           "vocab_size": 100, "n_layers": 2}
    run = fake(spans=ns, config=cfg)
    assert reader("per_layer", "decode_step_ms.serve").read(run) == \
        pytest.approx(200.0)
    mfu = reader("per_layer", "prefill_mfu.serve").read(run)
    assert mfu == pytest.approx(100 * 2 * bounds.hybrid_params(cfg) * 1000
                                / 989e12)
