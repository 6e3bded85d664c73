"""Sets of runs of one cell, each run a process of its own as a check
makes them, and the spread each metric shows: the distance between the
first and third quartile over the median (``statistics.quantiles``).

    python3 bench/tools/sets.py --workload <cell> --seeds 1,2,3,4,5,6 \\
        --sets 2 --seconds 48 [--trace 0]

Every set runs the same seeds.  Each run's result line goes to standard
output and to ``bench/out/sets-<cell>.jsonl``; then one summary line:
per metric each set's values, median and spread, and the wider spread.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from lib import stats  # noqa: E402


def one(workload: str, seed: int, seconds: float, trace: int):
    cmd = [sys.executable, str(BENCH / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       timeout=1500)
    lines = p.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        res = {"error": p.returncode, "stderr": p.stderr[-3000:]}
    res["seed"] = seed
    res["setup"] = next((json.loads(x[7:]) for x in lines
                         if x.startswith("setup: ")), None)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = BENCH / "out" / f"sets-{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            res = one(args.workload, seed, args.seconds, args.trace)
            res["set"] = k
            runs.append(res)
            line = json.dumps(res)
            print(line, flush=True)
            with open(out, "a") as f:
                f.write(line + "\n")
        sets.append(runs)
    summary = {}
    names = sorted({m for runs in sets for r in runs
                    for m in r.get("metrics", {})})
    for m in names:
        per = [[r["metrics"][m]["value"] for r in runs
                if m in r.get("metrics", {})] for runs in sets]
        spreads = [stats.quartile_spread(v) if len(v) >= 2 else None
                   for v in per]
        summary[m] = {"values": per,
                      "medians": [stats.median(v) for v in per if v],
                      "spreads": spreads,
                      "widest": max((s for s in spreads if s is not None),
                                    default=None)}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
