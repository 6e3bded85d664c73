"""Readings the limits of ``correct`` are set from: for each seed, one
run of a cell (a short window, or none) with the numbers its check
compares, and on the first seeds the same numbers of the cell's control
and planted faults, each with the reference put in the program's place.

    python3 bench/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10 --controls tf32 --control-seeds 3

One JSON line a seed on standard output, and the same lines appended to
``bench/out/readings-<cell>.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import run as entry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", default="")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cpu to rehearse at small sizes (default: the card)")
    args = ap.parse_args(argv)
    entry.environment()
    import torch
    from lib import harness
    out = BENCH / "out" / f"readings-{args.workload}.jsonl"
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        extra, notes = {}, {}

        def after(run, drv):
            if i < args.control_seeds:
                for kind in filter(None, args.controls.split(",")):
                    t0 = time.monotonic()
                    extra[kind] = drv.control(run, kind)
                    extra[kind + "_s"] = time.monotonic() - t0
            notes.update({k: v for k, v in run.notes.items()
                          if k not in ("checked", "picked", "reference")})
        t0 = time.monotonic()
        res = harness.execute(args.workload, seed, args.seconds, False,
                              after=after, log=lambda *_: None,
                              device=args.device and torch.device(args.device))
        line = {"workload": args.workload, "seed": seed,
                "program": {k: c["value"] for k, c in res["checks"].items()},
                "correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"], "controls": extra,
                "run_s": time.monotonic() - t0, "notes": notes,
                "kind": res["device"]["kind"]}
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
