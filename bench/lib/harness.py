"""One run of one cell: find its files by name, set it up, measure the
window, check what the window produced, and build the result line.

Everything a cell is made of is a file found by its name in
``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration as it is run (the entry's
  ``file``);
* ``workloads/<cell>.json``: the cell's traffic parameters; its ``kind``
  names the general generator in ``drivers/<kind>.py`` that reads them;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one reader per
  metric, ``read(run) -> float | None`` (None: nothing to read, and the
  metric is left out of the line).

A driver module has ``setup(run)``, ``window(run, deadline)`` and
``check(run) -> [(name, value, limit), ...]``.  The window runs on a
thread of its own, so that a traced run can profile a slice of it from
this one.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import threading
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

from . import spans as spans_lib
from . import trace as trace_lib

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The cards the cell asks for are not there."""


def forbidden_modules(names=None) -> List[str]:
    """Modules (default: the loaded ones) whose top-level name is a
    forbidden one, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def process_start() -> float:
    """``time.monotonic`` time at which this process started (Linux:
    /proc's start time against the boot clock); now where unreadable."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return time.monotonic() - (boot - start)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic()


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


class Cell:
    """A workload entry of BENCHMARK.json with its files."""

    def __init__(self, spec: Dict[str, Any], name: str, root: Path = ROOT,
                 bench: Path = BENCH):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
        self.name = name
        self.entry = by_name[name]
        self.chips = int(self.entry["chips"])
        cfg = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        with open(root / cfg["file"]) as f:
            self.config = json.load(f)
        with open(bench / "workloads" / f"{name}.json") as f:
            self.traffic = json.load(f)
        self.bench = bench

        def mine(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]

    def driver(self) -> ModuleType:
        kind = self.traffic["kind"]
        return load_module(self.bench / "drivers" / f"{kind}.py",
                           f"bench_driver_{kind}")

    def reader(self, section: str, name: str) -> ModuleType:
        folder = "end_to_end" if section == "end_to_end" else "metrics"
        return load_module(self.bench / folder / f"{name}.py",
                           f"bench_{folder}_{name.replace('.', '_')}")


class Run:
    """What a run knows: the cell, the seed, the device, and what set-up
    and the window recorded, for the drivers and the metric readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool,
                 device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.device = device
        self.spans = spans_lib.Spans(annotate=traced)
        self.records: Dict[str, Any] = {}
        self.setup_parts: Dict[str, float] = {}
        self.window_start = 0.0
        self.window_end = 0.0
        self.setup_s = 0.0
        self.attempted = 0
        self.failed = 0
        self.trace: Optional[trace_lib.Trace] = None
        self.notes: Dict[str, Any] = {}

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize(self.device)

    def part(self, name: str, t0: float) -> None:
        """Record set-up part `name` as taking from t0 until now."""
        self.setup_parts[name] = (self.setup_parts.get(name, 0.0)
                                  + time.monotonic() - t0)


def card(chips: int):
    """The first card, after checking that `chips` cards are there."""
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} cards, the cell asks "
                       f"for {chips}")
    return torch.device("cuda", 0)


def execute(workload: str, seed: int, seconds: float, traced: bool, *,
            spec: Optional[Dict[str, Any]] = None, root: Path = ROOT,
            bench: Path = BENCH, device=None, t_start: Optional[float] = None,
            log=print, after=None) -> Dict[str, Any]:
    """Run one cell once and return the result object (the line the
    benchmark prints).  ``device`` None means the card, checked; the CPU
    tests pass a CPU device.  ``after(run, driver)``, if given, runs once
    the checks are done (the tools that read controls use it)."""
    t_start = process_start() if t_start is None else t_start
    spec = spec if spec is not None else load_spec(root)
    cell = Cell(spec, workload, root, bench)
    if device is None:
        device = card(cell.chips)
    drv = cell.driver()
    run = Run(cell, seed, seconds, traced, device)

    drv.setup(run)
    if traced and run.on_card:
        t0 = time.monotonic()
        trace_lib.warm_up()
        run.part("profiler", t0)
    run.window_start = time.monotonic()
    run.setup_s = run.window_start - t_start
    log("setup: " + json.dumps({"setup_s": run.setup_s, **run.setup_parts}))

    deadline = run.window_start + seconds
    stop = threading.Event()
    error: List[BaseException] = []

    def window():
        try:
            drv.window(run, deadline)
        except BaseException as e:       # handed to the caller below
            error.append(e)
        finally:
            stop.set()

    th = threading.Thread(target=window, name="bench-window")
    th.start()
    if traced and run.on_card:
        offset = float(cell.traffic.get("trace_after_s", 0.3 * seconds))
        length = float(cell.traffic.get("trace_slice_s", 2.0))
        sl = trace_lib.Slice()
        sl.run(run.window_start + offset, length, stop)
        run.trace = sl.trace
    th.join()
    if error:
        raise error[0]
    if run.window_end <= run.window_start:
        run.window_end = time.monotonic()

    peak = 0
    if run.on_card:
        import torch
        peak = torch.cuda.max_memory_allocated(device)
    checks = drv.check(run)
    correct = all(v <= lim for _, v, lim in checks) and bool(checks)
    if after is not None:
        after(run, drv)

    section = cell.per_layer if traced else cell.end_to_end
    metrics: Dict[str, Dict[str, Any]] = {}
    for m in section:
        value = cell.reader("per_layer" if traced else "end_to_end",
                            m["name"]).read(run)
        if value is not None and not math.isnan(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result: Dict[str, Any] = {"correct": correct, "attempted": run.attempted,
                              "failed": run.failed, "metrics": metrics,
                              "device": device_info(run, peak)}
    if traced and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def device_info(run: Run, peak: int) -> Dict[str, Any]:
    if run.on_card:
        import torch
        kind = torch.cuda.get_device_name(run.device)
        info = {"platform": "gpu", "kind": kind, "count": run.cell.chips,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    if run.traced:
        tr = run.trace
        info["busy_s"] = tr.busy_s() if tr is not None else 0.0
        info["window_s"] = tr.window_s if tr is not None else 0.0
    return info
