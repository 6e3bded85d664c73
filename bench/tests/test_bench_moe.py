"""The mixture-of-experts cell (DeepSeek-V2-Lite training on one chip's
share of the experts): a whole run on the CPU at smoke sizes, correct,
and turned incorrect by faults planted in the program; its yardstick's
arithmetic pinned by hand; its readers on synthetic events."""
from __future__ import annotations

import types

import pytest

from bench_support import BENCH, ROOT, load, run_cell
from moe_support import MOE_CELL, MOE_METRICS, moe_smoke_copy

from lib import harness, moe_bounds
from lib.trace import Event, Trace

CFG = load(BENCH / "configs" / "deepseek-v2-lite.json")


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py",
                               f"t_moe_{name.replace('.', '_')}")


# ------------------------------------------------------------ whole runs
def test_cell_runs_end_to_end_and_is_correct(tmp_path):
    root = moe_smoke_copy(tmp_path)
    e2e = run_cell(root, MOE_CELL, seconds=0.5)
    assert e2e["correct"], e2e["checks"]
    assert set(e2e["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert e2e["attempted"] >= 1
    layer = run_cell(root, MOE_CELL, seconds=0.5, traced=True)
    assert layer["correct"]
    # no trace on the CPU: the host-clock share alone is read
    assert layer["metrics"]["train_mfu.moe"]["value"] > 0


def _renorm(monkeypatch):
    from repro_torch.models.layers import moe
    real = moe._route

    def route(*a, **k):
        top_p, top_i, aux = real(*a, **k)
        return top_p / top_p.sum(-1, keepdim=True), top_i, aux
    monkeypatch.setattr(moe, "_route", route)


def _no_mscale(monkeypatch):
    from repro_torch.models.layers import attention
    monkeypatch.setattr(attention, "mla_scale", lambda cfg: (
        cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)


def _drop_expert(monkeypatch):
    from repro_torch.models.layers import moe
    real = moe.dropfree_plan
    monkeypatch.setattr(moe, "dropfree_plan", lambda top_i, top_p, held: real(
        top_i.masked_fill(top_i == 0, held), top_p, held))


def _unchanged(monkeypatch):
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "update", lambda p, g, opt, step, h, s=1.0: (
        p, opt, {"grad_norm": adamw.global_norm(g)}))


@pytest.mark.parametrize("plant", [_renorm, _no_mscale, _drop_expert,
                                   _unchanged], ids=lambda f: f.__name__[1:])
def test_faults_planted_in_the_program_fail_the_check(tmp_path, monkeypatch,
                                                      plant):
    """The top-k renormalised, YaRN's softmax factor left out, held
    expert 0's rows dropped, a step that changes nothing."""
    plant(monkeypatch)
    root = moe_smoke_copy(tmp_path)
    assert not run_cell(root, MOE_CELL, seconds=0.5)["correct"]


# ------------------------------------------------------------ yardstick
def test_active_parameters_and_model_flops_at_the_cells_config():
    n = moe_bounds.active_params(CFG)
    assert n == pytest.approx(1_086.9e6, abs=0.5e6)
    # by hand: head 12800 x 2048; dense MLA 13,762,560 + 3 x 2048 x 10944;
    # 26 MoE layers of MLA + 3 x 2048 x 2816 + 2048 x 64 + 0.75 x 8,650,752
    assert n == 26_214_400 + 81_002_496 + 26 * 37_683_200
    assert moe_bounds.mla_params(CFG) == 13_762_560
    assert moe_bounds.attention_flops(CFG, 4096) == 6 * 27 * 16 * 320 * 2048
    assert moe_bounds.train_flops(CFG, 32768, 4096) == pytest.approx(
        32768 * (6 * n + 1_698_693_120))


@pytest.mark.parametrize("rows, flops, nbytes, by", [
    # 2 r 2048 1408 FLOPs; 2 (r 2048 + r 1408 + 8 x 2048 x 1408) bytes
    (0, 0, 46_137_344, "bytes"),
    (1, 5_767_168, 46_144_256, "bytes"),
    (1536, 8_858_370_048, 56_754_176, "bytes"),
    (12288, 70_866_960_384, 131_072_000, "operations"),
    (98304, 566_935_683_072, 725_614_592, "operations"),
])
def test_grouped_product_bounds(rows, flops, nbytes, by):
    b = moe_bounds.product_bound(CFG, rows)
    assert (b["flops"], b["bytes"], b["bound_by"]) == (flops, nbytes, by)
    assert b["seconds"] == pytest.approx(max(flops / 989e12,
                                             nbytes / 3.35e12))


# ------------------------------------------------------------ readers
MAIN, AUTOGRAD = 2, 4


GG = ("void cutlass::device_kernel<cutlass::gemm::kernel::GemmUniversal<"
      "cutlass::gemm::GroupProblemShape<cute::tuple<int, int, int> > > >")


def _launched(name, corr, thread, t, start, end):
    return [Event("cudaLaunchKernel", "runtime", t, t + 0.001, thread, corr),
            Event(name, "device", start, end, 0, corr)]


def _events():
    """A slice [1, 10]: two whole MoE sublayers (forward 30 ms of device
    time, recompute 50 ms) and one cut by the slice's start."""
    cpu = lambda n, s, e, th=MAIN: Event(n, "cpu", s, e, th, 0)  # noqa
    return [
        Event("bench.slice", "span", 1.0, 10.0, 1, 0),
        cpu("repro.model.moe recompute=0", 0.9, 1.2),
        *_launched(GG, 1, MAIN, 0.95, 1.01, 1.02),
        cpu("repro.model.moe recompute=0", 2.0, 2.2),
        cpu("repro.model.moe.experts recompute=0", 2.01, 2.1),
        *_launched(GG, 2, MAIN, 2.02, 2.03, 2.05),
        *_launched(GG, 3, MAIN, 2.03, 2.05, 2.06),
        *_launched("elementwise", 4, MAIN, 2.15, 2.15, 2.15),
        cpu("repro.model.moe recompute=1", 4.0, 4.3, AUTOGRAD),
        *_launched(GG, 5, AUTOGRAD, 4.01, 4.02, 4.06),
        *_launched(GG, 6, AUTOGRAD, 4.02, 4.06, 4.07),
        *_launched(GG, 7, AUTOGRAD, 4.5, 4.5, 4.6),
    ]


def _run(trace=None, **kw):
    return types.SimpleNamespace(**{"trace": trace, "config": CFG,
                                    "records": {}, **kw})


def test_moe_ms_is_the_median_of_whole_sublayers():
    got = reader("moe_ms.train").read(_run(Trace(_events())))
    assert got == pytest.approx(40.0)           # 30 and 50 ms


def test_moe_gemm_roofline_over_every_launch_in_the_slice():
    rows = 12288
    run = _run(Trace(_events()), records={"moe": {"rows_per_call": rows}})
    need = 6 * moe_bounds.product_bound(CFG, rows)["seconds"]
    spent = 0.01 + 0.02 + 0.01 + 0.04 + 0.01 + 0.1
    got = reader("moe_gemm_roofline.train").read(run)
    assert got == pytest.approx(100 * need / spent)


def test_train_mfu_moe_from_the_window():
    steps = [{"tokens": 32768}, {"tokens": 32768}]
    run = _run(records={"steps": steps, "microbatch": (4, 4096)},
               window_s=10.0)
    want = 100 * moe_bounds.train_flops(CFG, 65536, 4096) / (10.0 * 989e12)
    assert reader("train_mfu.moe").read(run) == pytest.approx(want)


@pytest.mark.parametrize("name", [m["name"] for m in MOE_METRICS])
def test_readers_find_nothing_without_their_inputs(name):
    run = _run(records={"steps": [], "microbatch": (4, 4096)}, window_s=0.0)
    assert reader(name).read(run) is None


@pytest.mark.parametrize("entry", MOE_METRICS, ids=lambda m: m["name"])
def test_entries_match_their_readers(entry):
    mod = reader(entry["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["better"], entry["source"], entry["layer"],
        entry["moves"])
    spec = load(ROOT / "BENCHMARK.json")
    assert MOE_CELL in {w["name"] for w in spec["workloads"]}
