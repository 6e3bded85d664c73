"""Helpers the benchmark's tests share: paths, a copy of the benchmark
at smoke sizes for the CPU, and a card fixture."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# smoke sizes: the program's own small Hymba, tiny K-Means scenarios and
# a short serving mix, so that a whole run takes seconds on the CPU
SMOKE_HYMBA = dict(n_layers=3, d_model=64, n_heads=5, n_kv_heads=1,
                   head_dim=16, d_ff=128, vocab_size=512, ssm_d_state=4,
                   sliding_window=32, full_attn_layers=[0, 2],
                   dtype="float32")
SMOKE_SCENARIOS = [{"name": "a", "points": 2000, "clusters": 8},
                   {"name": "b", "points": 5000, "clusters": 4},
                   {"name": "c", "points": 1000, "clusters": 6}]
SMOKE_TRAFFIC = {
    "hymba-1.5b.train-8x2048": dict(batch=4, seq=64, rows=2),
    # the chat mix cut by the window's ratio: prompts from 1/8 of the
    # window (32) to twice it, as 256-4096 are of 2048
    "hymba-1.5b.serve-chat": dict(prompt_bucket=16, max_seq=160,
                                  prompt_tokens=[4, 64],
                                  output_tokens=[4, 40], slots=4,
                                  rate_per_s=4.0, check_tokens=60),
}
# The serving cell and its metrics, as BENCHMARK.json will list them once
# the program's windowed decode is mended.  Until then they are not in
# BENCHMARK.json, and the tests add them to their copies from here.
SERVE_CELL = "hymba-1.5b.serve-chat"
SERVING = {
    "workloads": [
        {"name": SERVE_CELL, "config": "hymba-1.5b", "traffic": "serve-chat",
         "chips": 1, "why": "Poisson chat arrivals at 0.8 of the knee, "
         "prompts 256-4096, outputs 16-128, 32 slots: engine, host-bound "
         "decode, prefill attention"}],
    "end_to_end": [
        {"name": "ttft_p95_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "workloads": [SERVE_CELL]},
        {"name": "tpot_p95_ms", "unit": "ms", "better": "lower",
         "source": "host_clock", "workloads": [SERVE_CELL]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": moves, "workloads": [SERVE_CELL]}
        for name, unit, better, source, layer, moves in [
            ("queue_wait_ms.serve", "ms", "lower", "program_span", "engine",
             "ttft_p95_ms"),
            ("prefill_mfu.serve", "%", "higher", "program_span",
             "serving steps, transformer stack", "ttft_p95_ms"),
            ("decode_step_ms.serve", "ms", "lower", "program_span",
             "serving steps, transformer stack", "tpot_p95_ms"),
            ("k3_roofline.serve", "%", "higher", "device_trace", "kernels",
             "ttft_p95_ms"),
            ("device_idle.serve", "%", "lower", "device_trace", "device",
             "tpot_p95_ms")]],
}


# The K-Means cell and its metrics, as BENCHMARK.json listed them until
# the driver's checks read fits/s too unsteady for any bound it allows
# (the host's speed moves; PERF.md, Open questions).  Its files stay, and
# the tests add it to their copies from here.
KMEANS_CELL = "kmeans-fig6.mode1-local"
KMEANS = {
    "configs": [
        {"name": "kmeans-fig6", "source": "https://arxiv.org/abs/1602.00345",
         "file": "bench/configs/kmeans-fig6.json", "reduced": [],
         "why": "the paper's own deployment (Fig 6): K-Means CUs on a "
         "pilot, 3-D points, 2 iterations, its three scenarios uncut"}],
    "workloads": [
        {"name": KMEANS_CELL, "config": "kmeans-fig6",
         "traffic": "mode1-local", "chips": 1,
         "why": "4 closed-loop clients, one K-Means CU each at a time over "
         "the 3 Fig 6 scenarios, data-local: Pilot core, analytics engine "
         "and K1"}],
    "end_to_end": [
        {"name": "kmeans_fits_per_s", "unit": "fits/s", "better": "higher",
         "source": "host_clock", "workloads": [KMEANS_CELL]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "kmeans_fits_per_s",
         "workloads": [KMEANS_CELL]}
        for name, unit, better, source, layer in [
            ("cu_overhead_ms.kmeans", "ms", "lower", "program_span",
             "Pilot core"),
            ("kmeans_mfu", "%", "higher", "host_clock", "analytics"),
            ("k1_roofline.kmeans", "%", "higher", "device_trace", "kernels"),
            ("device_idle.kmeans", "%", "lower", "device_trace", "device")]],
}


def with_kept(spec):
    """`spec` with the cells kept out of BENCHMARK.json (serving and
    K-Means) and their metrics added."""
    out = dict(spec)
    for kept in (SERVING, KMEANS):
        for section, entries in kept.items():
            out[section] = list(out[section]) + entries
    return out


def load(path: Path):
    with open(path) as f:
        return json.load(f)


def dump(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def smoke_copy(tmp: Path) -> Path:
    """A copy of BENCHMARK.json, with the kept cells added, and of
    bench/ under `tmp`, with every configuration and traffic cut to smoke
    sizes; returns its root."""
    dump(with_kept(load(ROOT / "BENCHMARK.json")), tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    cfgs = tmp / "bench" / "configs"
    h = load(cfgs / "hymba-1.5b.json")
    h.update(SMOKE_HYMBA)
    dump(h, cfgs / "hymba-1.5b.json")
    k = load(cfgs / "kmeans-fig6.json")
    k["scenarios"] = SMOKE_SCENARIOS
    dump(k, cfgs / "kmeans-fig6.json")
    for cell, changes in SMOKE_TRAFFIC.items():
        path = tmp / "bench" / "workloads" / f"{cell}.json"
        w = load(path)
        w.update(changes)
        dump(w, path)
    return tmp


def run_cell(root: Path, cell: str, seed: int = 7, seconds: float = 1.0,
             traced: bool = False):
    """One run of `cell` from the copy at `root`, on the CPU."""
    import torch
    from lib import harness
    return harness.execute(cell, seed, seconds, traced, root=root,
                           bench=root / "bench", device=torch.device("cpu"),
                           log=lambda *_: None)


@pytest.fixture
def card():
    """The card, or a skip: the control is read on the card at the
    cell's own size (a CPU computes no TF32 product)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
