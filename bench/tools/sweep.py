"""Find a serving cell's knee: one set-up, then a window at each offered
rate, with the backlog (requests not yet decoding) sampled through it.

    python3 bench/tools/sweep.py --workload hymba-1.5b.serve-chat \\
        --rates 1,2,3,4 --seconds 40 --seed 5

The cell has to be a workload of ``BENCHMARK.json``.  The knee is the
highest rate at which the backlog does not grow over the window.  One JSON line a rate on standard output (and appended to
``bench/out/sweep-<cell>.jsonl``): requests due and finished, TTFT and
TPOT percentiles, the backlog's samples and its slope over the window's
second half.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import run as entry  # noqa: E402


def slope(samples):
    """Least-squares slope (requests a second) of (t, backlog) samples."""
    if len(samples) < 2:
        return 0.0
    n = len(samples)
    mt = sum(t for t, _ in samples) / n
    mb = sum(b for _, b in samples) / n
    var = sum((t - mt) ** 2 for t, _ in samples)
    return sum((t - mt) * (b - mb) for t, b in samples) / var if var else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    entry.environment()
    from lib import harness, stats
    spec = harness.load_spec()
    cell = harness.Cell(spec, args.workload)
    drv = cell.driver()
    run = harness.Run(cell, args.seed, args.seconds, False,
                      harness.card(cell.chips))
    drv.setup(run)
    engine = run.records["engine"]
    out = BENCH / "out" / f"sweep-{args.workload}.jsonl"
    for rate in (float(r) for r in args.rates.split(",")):
        run.traffic = dict(cell.traffic, rate_per_s=rate)
        run.records["schedule"] = drv.schedule(run)
        samples, stop = [], threading.Event()
        run.window_start = time.monotonic()

        def sample():
            while not stop.wait(0.25):
                samples.append((time.monotonic() - run.window_start,
                                engine.backlog))
        th = threading.Thread(target=sample)
        th.start()
        drv.window(run, run.window_start + args.seconds)
        stop.set()
        th.join()
        reqs = run.records["requests"]
        ttft = [r["t_first"] - r["due"] if r["t_first"] else math.inf
                for r in reqs]
        tpot = [(r["t_done"] - r["t_first"]) / (r["n_out"] - 1)
                for r in reqs if r["t_done"] and r["n_out"] >= 2]
        half = [s for s in samples if s[0] >= args.seconds / 2
                and s[0] <= args.seconds]
        line = {"workload": args.workload, "rate_per_s": rate,
                "due": len(reqs), "failed": run.failed,
                "ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
                "ttft_p95_ms": 1e3 * stats.percentile(ttft, 95),
                "tpot_p50_ms": 1e3 * stats.percentile(tpot, 50)
                if tpot else None,
                "tpot_p95_ms": 1e3 * stats.percentile(tpot, 95)
                if tpot else None,
                "backlog_slope_per_s": slope(half),
                "backlog_max": max((b for _, b in samples), default=0),
                "backlog": [b for _, b in samples[::4]],
                "kind": harness.device_info(run, 0)["kind"]}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
