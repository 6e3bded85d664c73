"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit); the last lines of standard error
repeat the checks.  Exit codes: 0 a result, 2 no card (or too few),
3 the program could not be loaded, 4 JAX or the JAX package was loaded,
1 anything else.  See bench/README.md.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
STATE = BENCH / "out" / "state"


def environment() -> None:
    """Caches inside the checkout at fixed paths, and no JAX through a
    library that would load it on its own."""
    STATE.mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(STATE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(STATE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(STATE / "inductor")
    # the autotuner's registry: a fixed file no run writes, so every run
    # takes the kernels' shipped block sizes
    os.environ["REPRO_AUTOTUNE_REGISTRY"] = str(STATE / "autotune.json")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    from lib import harness
    t_start = harness.process_start()
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the program (src/repro_torch) cannot be loaded: {e}",
              file=sys.stderr)
        return 3
    try:
        result = harness.execute(args.workload, args.seed, args.seconds,
                                 bool(args.trace), t_start=t_start)
    except harness.NoDevice as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, m in list(result["metrics"].items()):
        if not math.isfinite(m["value"]):
            print(f"bench: metric {name} is {m['value']}: left out",
                  file=sys.stderr)
            del result["metrics"][name]
    for c in result["checks"].values():
        c["value"] = finite(c["value"])
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
