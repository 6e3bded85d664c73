#!/usr/bin/env python3
"""Time K1 (the K-Means assignment scan and merge) at every candidate
block size and at each of the paper's three K-Means shapes.

Run from the repository root on a machine with one CUDA card:

    python3 tools/kmeans_blocks.py [--out FILE.json]

For each shape and each ``autotune.candidates_kmeans`` (bn, bk), with the
split count ``ops.split_count`` chooses for it, prints the device time of
one assignment (scan + merge, replayed from a CUDA graph), the
time of back-to-back bare launches (CUDA events) and the share of the
bound that ``chip_smoke.assign_bound`` gives, then the card's name and
power limit.  The results also go to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kmeans_blocks: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.analytics import kmeans as km
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.kmeans import kmeans as km_kernel
    from repro_torch.kernels.kmeans import ops
    from repro_torch.launch import platform

    platform.configure("cuda")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    build.build_all([km_kernel.SOURCE])
    gen = torch.Generator(device=dev).manual_seed(0)
    d = km.PAPER_DIM
    rows = []
    for name, (n, k) in km.PAPER_SCENARIOS.items():
        p = km.make_dataset(n, seed=1, device=dev)
        c = p[torch.randperm(n, generator=gen, device=dev)[:k]].contiguous()
        bound = cs.assign_bound(n, k, d)
        bound_ms = 1e3 * max(bound["t_bytes"], bound["t_ops"])
        want = None
        for cfg in autotune.candidates_kmeans(n, k, d):
            splits = cs.chosen_splits(ops, km_kernel, n, k, d, cfg, sms)
            bare = cs.bare_launcher(torch, km_kernel, p, c, cfg["bn"],
                                    cfg["bk"], splits)
            got = bare()
            if want is None:
                want = tuple(t.clone() for t in got)
            cs.check(torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1]),
                     f"{name} {cfg}: not bitwise equal to the first config")
            t_dev = cs.graph_ms(torch, bare)
            t_ev = cs.cuda_ms(torch, bare)
            blocks = -(-n // (cfg["bn"] * km_kernel.rows(d))) * splits
            rows.append({"shape": name, **cfg, "splits": splits,
                         "blocks": blocks, "device_ms": t_dev,
                         "bare_ms": t_ev, "bound_ms": bound_ms,
                         "share_of_bound": bound_ms / t_dev,
                         "default": cfg == autotune.DEFAULTS["kmeans"]})
            print(f"{name} bn {cfg['bn']:3d} bk {cfg['bk']:4d} splits "
                  f"{splits:3d} blocks {blocks:5d}: device {t_dev:.4f} ms, "
                  f"bare {t_ev:.4f} ms, {100 * bound_ms / t_dev:.1f} % of "
                  f"the bound {bound_ms:.4f} ms"
                  f"{' (default)' if rows[-1]['default'] else ''}")
        best = min((r for r in rows if r["shape"] == name),
                   key=lambda r: r["device_ms"])
        print(f"{name}: best bn {best['bn']} bk {best['bk']} "
              f"{best['device_ms']:.4f} ms")
    card = cs.card_line()
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
