"""A configuration, a cell and a per-layer metric are added as new files
and entries, with no existing file edited, and the harness finds and
runs them."""
from __future__ import annotations

import json

from bench_support import dump, load, run_cell, smoke_copy

NEW_METRIC = '''"""Decode steps the window ran."""
UNIT = "steps"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "ttft_p95_ms"


def read(run):
    return float(sum(s.start >= run.window_start
                     for s in run.spans.named("bench.step")))
'''


def test_new_config_cell_and_metric_are_found_by_name(tmp_path):
    root = smoke_copy(tmp_path)
    bench = root / "bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    cfg = load(bench / "configs" / "hymba-1.5b.json")
    cfg.update(name="hymba-tiny", n_layers=2, full_attn_layers=[0])
    dump(cfg, bench / "configs" / "hymba-tiny.json")
    cell = load(bench / "workloads" / "hymba-1.5b.serve-chat.json")
    cell.update(why="a shorter mix on a two-layer cut", rate_per_s=3.0,
                output_tokens=[4, 12])
    dump(cell, bench / "workloads" / "hymba-tiny.serve-short.json")
    (bench / "metrics" / "decode_steps.serve.py").write_text(NEW_METRIC)

    spec = load(root / "BENCHMARK.json")
    spec["configs"].append({"name": "hymba-tiny", "source": "test",
                            "file": "bench/configs/hymba-tiny.json",
                            "reduced": [], "why": "a test configuration"})
    spec["workloads"].append({"name": "hymba-tiny.serve-short",
                              "config": "hymba-tiny",
                              "traffic": "serve-short", "chips": 1,
                              "why": cell["why"]})
    for m in spec["end_to_end"]:
        if m["name"] == "ttft_p95_ms":
            m["workloads"].append("hymba-tiny.serve-short")
    spec["per_layer"].append({"name": "decode_steps.serve", "unit": "steps",
                              "better": "higher", "source": "program_span",
                              "layer": "engine", "moves": "ttft_p95_ms",
                              "workloads": ["hymba-tiny.serve-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    e2e = run_cell(root, "hymba-tiny.serve-short", seconds=0.5)
    assert set(e2e["metrics"]) == {"ttft_p95_ms", "setup_s"}
    layer = run_cell(root, "hymba-tiny.serve-short", seconds=0.5,
                     traced=True)
    assert layer["metrics"]["decode_steps.serve"]["value"] > 0
    assert layer["correct"]
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())
