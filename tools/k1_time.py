#!/usr/bin/env python3
"""Time K1 (the K-Means assignment kernel) of a checkout of the port at
the paper's three K-Means shapes, host time excluded.

Run from the repository root on a machine with one CUDA card:

    python3 tools/k1_time.py [--src PATH/src] [--out FILE.json]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so one call can time an older checkout's
kernel beside this one's.  For each shape it captures 20 calls in a CUDA
graph and times its replay with CUDA events: the bare launch (the
kernels' launchers on preallocated outputs; a module without
``partials`` holds the earlier single-kernel K1, timed without its
wrapper's |p|^2 epilogue) and the public wrapper ``ops.assign``
(the whole function, epilogue included).  It also times 20 wrapper calls
back to back with events, which holds the host's cost.  Prints one line
per shape and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def bare(torch, kernel, ops, autotune, p, c):
    """The kernels' launchers on preallocated outputs, as the wrapper
    would call them at its default blocks."""
    n, d = p.shape
    k = c.shape[0]
    blocks = autotune.DEFAULTS["kmeans"]
    idx = torch.empty(n, dtype=torch.int32, device=p.device)
    dist = torch.empty(n, dtype=torch.float32, device=p.device)
    if not hasattr(kernel, "partials"):       # the earlier, unsplit K1
        return (lambda: kernel.assign_cuda(p, c, idx, dist, **blocks)), 1
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    splits = ops.split_count(n, k, blocks["bn"], blocks["bk"],
                             kernel.rows(d), sms)
    part = kernel.partials(splits, n, p.device)
    return (lambda: kernel.assign_cuda(p, c, idx, dist, part=part,
                                       **blocks)), splits


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_time: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    # after chip_smoke, which puts this checkout's src first: the timed
    # checkout's repro_torch is the one imported
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.analytics import kmeans as km
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.kmeans import kmeans as kernel
    from repro_torch.kernels.kmeans import ops
    from repro_torch.launch import platform

    platform.configure("cuda")
    dev = torch.device("cuda", 0)
    build.build_all([kernel.SOURCE])
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, (n, k) in km.PAPER_SCENARIOS.items():
        p = km.make_dataset(n, seed=1, device=dev)
        c = p[torch.randperm(n, generator=gen, device=dev)[:k]].contiguous()
        run, splits = bare(torch, kernel, ops, autotune, p, c)
        row = {"shape": name, "n": n, "k": k, "splits": splits,
               "bare_graph_ms": cs.graph_ms(torch, run),
               "wrapper_graph_ms": cs.graph_ms(torch,
                                               lambda: ops.assign(p, c)),
               "wrapper_events_ms": cs.cuda_ms(torch,
                                               lambda: ops.assign(p, c))}
        rows.append(row)
        print(f"{name}: bare launch {row['bare_graph_ms']:.4f} ms, wrapper "
              f"{row['wrapper_graph_ms']:.4f} ms on the device, "
              f"{row['wrapper_events_ms']:.4f} ms back to back "
              f"({splits} splits)")
    total = sum(r["bare_graph_ms"] for r in rows)
    card = cs.card_line()
    print(f"bare launches summed: {total:.4f} ms; src {args.src}")
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "src": args.src, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
