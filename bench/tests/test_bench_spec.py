"""BENCHMARK.json against the benchmark's rules of form, and against the
files the harness finds by name."""
from __future__ import annotations

import importlib.util
import re

import pytest

from bench_support import BENCH, ROOT, load

SPEC = load(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj"
                   r"|head|expan|experts_per|top_k|d_model|d_ff|d_inner")


def metric_module(section: str, name: str):
    folder = "end_to_end" if section == "end_to_end" else "metrics"
    path = BENCH / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{section}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_full_check_fits_its_time_at_24_cells():
    rs = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_legal_and_unique(section):
    names = [e["name"] for e in SPEC[section]]
    assert names and len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    limits = {"configs": 24, "workloads": 24, "end_to_end": 16,
              "per_layer": 128}
    assert len(names) <= limits[section]


def test_metric_names_unique_across_sections():
    names = [m["name"] for s in ("end_to_end", "per_layer") for m in SPEC[s]]
    assert len(names) == len(set(names))


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        body = load(ROOT / c["file"])
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k)


def test_workloads():
    cfgs = {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(pairs) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and one_line(w["why"])
        traffic = load(BENCH / "workloads" / f"{w['name']}.json")
        assert (BENCH / "drivers" / f"{traffic['kind']}.py").exists()
        assert traffic["why"] == w["why"]


def test_end_to_end_metrics():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        mod = metric_module("end_to_end", m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
            m["unit"], m["better"], m["source"])


def cells_reporting(metric):
    return set(metric.get("workloads",
                          [w["name"] for w in SPEC["workloads"]]))


def test_per_layer_metrics_move_one_reported_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        # every cell that reports this metric reports what it moves
        assert cells_reporting(m) <= cells_reporting(e2e[m["moves"]])
        mod = metric_module("per_layer", m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"])
        layers.setdefault(m["layer"], m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m for m in SPEC["end_to_end"] if w["name"] in cells_reporting(m)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in cells_reporting(m) for m in SPEC["per_layer"])


def test_roofline_cells_report_a_step_mfu_moving_the_same_metric():
    for m in SPEC["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and cells_reporting(m) <= cells_reporting(o)
                       for o in SPEC["per_layer"])


def test_files_under_paths_are_named_from_name_characters():
    for f in BENCH.rglob("*"):
        if "out" in f.relative_to(BENCH).parts or "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
