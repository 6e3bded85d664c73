"""The mixture-of-experts cell's helpers for the benchmark's tests: its
three per-layer metrics as entries (their readers are in
``bench/metrics/``), a spec with them, and a copy of the benchmark with
the cell cut to smoke sizes for the CPU.

The entries are kept here, not in BENCHMARK.json: the benchmark's own
test of the program's spans (``test_bench_program_spans.py``) holds the
last five per-layer entries to its five metrics, so an entry appended
after them fails it, and one put before them would read as a change to
those five accepted entries.  They wait for a benchmark change that
frees that test."""
from __future__ import annotations

from pathlib import Path

from bench_support import dump, load, smoke_copy

MOE_CELL = "deepseek-v2-lite.train-8x4096"
MOE_METRICS = [
    {"name": name, "unit": unit, "better": better, "source": source,
     "layer": layer, "moves": "train_tokens_per_s", "workloads": [MOE_CELL]}
    for name, unit, better, source, layer in [
        ("moe_ms.train", "ms", "lower", "program_span", "MoE layer"),
        ("moe_gemm_roofline.train", "%", "higher", "device_trace",
         "kernels"),
        ("train_mfu.moe", "%", "higher", "host_clock",
         "trainer, step, optimizer")]]
# the program's smoke DeepSeek-V2-Lite: every mechanism, small widths
SMOKE_MOE = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                 head_dim=24, d_ff=32, vocab_size=512, moe_n_routed=16,
                 moe_n_shared=2, moe_top_k=3, moe_d_ff=32, dense_d_ff=96,
                 moe_experts_held=8, kv_lora_rank=32, qk_nope_dim=16,
                 qk_rope_dim=8, v_head_dim=16, dtype="float32")
SMOKE_MOE_TRAFFIC = dict(batch=4, seq=64, rows=2)


def with_moe(spec):
    """`spec` with the cell's per-layer metrics added."""
    out = dict(spec)
    out["per_layer"] = list(spec["per_layer"]) + MOE_METRICS
    return out


def moe_smoke_copy(tmp: Path, config=None) -> Path:
    """``smoke_copy`` with the MoE cell cut to smoke sizes (and `config`
    changes on top) and its metrics in the copy's BENCHMARK.json."""
    root = smoke_copy(tmp)
    dump(with_moe(load(root / "BENCHMARK.json")), root / "BENCHMARK.json")
    path = root / "bench" / "configs" / "deepseek-v2-lite.json"
    cfg = load(path)
    cfg.update(SMOKE_MOE, **(config or {}))
    dump(cfg, path)
    path = root / "bench" / "workloads" / f"{MOE_CELL}.json"
    w = load(path)
    w.update(SMOKE_MOE_TRAFFIC)
    dump(w, path)
    return root
