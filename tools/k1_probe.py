#!/usr/bin/env python3
"""Probe what bounds K1's scan on the card: build altered copies of
``kmeans_assign.cu`` and time each at the paper's three K-Means shapes.

Run from the repository root on a machine with one CUDA card:

    python3 tools/k1_probe.py [--out FILE.json]

Each probe changes one thing in a copy of the source (an anchor that is
missing from the source stops the script):

- ``as built``: no change;
- ``no scan loop``: the centroid loop runs no group, so what is left is
  the fixed cost (points read, tiles staged, the index recovered, results
  written, the merge);
- ``D - 1 FMAs a pair`` and ``D + 3 FMAs a pair``: one FMA fewer or three
  more in every score (the results are wrong; only the time counts);
- ``R = 6`` and ``R = 8``: more points a thread at d <= 4.

Every probe is timed at the default blocks and the split count the
wrapper would choose for its R, 20 calls captured in a CUDA graph (scan
and merge).  It also prints the registers of each probe's d = 3 scan
(``-Xptxas -v``) and, from ``cuobjdump -sass`` of the build as it is,
the instructions of the d = 3 scan's innermost loop by opcode.  Then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LOOP = "    for (int g = 0; g < tg; g += KM_GROUP) {"
FMA = ("for (int j = 0; j < D; ++j) s = fmaf(pk[j], p[r][j], s);\n"
       "          m[r]")
ROWS = "return d <= 8 ? 4 :"
PROBES = {
    "as built": [],
    "no scan loop": [(LOOP, LOOP.replace("g < tg;", "g < tg * (n < 0);"))],
    "D - 1 FMAs a pair": [(FMA, FMA.replace("j < D;", "j < D - 1;"))],
    "D + 3 FMAs a pair": [(FMA, FMA.replace(
        "\n          m[r]", "\n#pragma unroll\n          for (int j = 0; j < D;"
        " ++j) s = fmaf(pk[j], s, p[r][j]);\n          m[r]"))],
    "R = 6": [(ROWS, "return d <= 4 ? 6 : d <= 8 ? 4 :")],
    "R = 8": [(ROWS, "return d <= 4 ? 8 : d <= 8 ? 4 :")],
}


def loop_opcodes(sass: str) -> collections.Counter:
    """Opcodes of the innermost loop that holds the shared loads: the
    shortest body of a backward branch that holds an LDS and an FFMA."""
    ins = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                     r"\s*([^;]*);", line)
        if m:
            ins.append((int(m[1], 16), m[3], m[4]))
    best = collections.Counter()
    for addr, op, args in ins:
        target = re.match(r"(0x[0-9a-f]+)", args.strip())
        if op == "BRA" and target and int(target[1], 16) < addr:
            body = collections.Counter(
                o.split(".")[0] for a, o, _ in ins
                if int(target[1], 16) <= a <= addr)
            if body["LDS"] and body["FFMA"] and (
                    not best or sum(body.values()) < sum(best.values())):
                best = body
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.analytics import kmeans as km
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels.kmeans import kmeans as kernel
    from repro_torch.kernels.kmeans import ops
    from repro_torch.launch import platform

    platform.configure("cuda")
    source = kernel.SOURCE.read_text()
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(PROBES.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"probe {name!r}: anchor not in source")
            text = text.replace(old, new)
        cu = out_dir / f"probe{i}.cu"
        cu.write_text(text)
        log = open(out_dir / f"probe{i}.log", "w")
        jobs[name] = (out_dir / f"libprobe{i}.so", out_dir / f"probe{i}.log",
                      subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o",
                                        str(out_dir / f"libprobe{i}.so"),
                                        str(cu)], stdout=log,
                                       stderr=subprocess.STDOUT))
        log.close()
    regs = {}
    for name, (lib, log, proc) in jobs.items():
        if proc.wait():
            raise RuntimeError(f"probe {name!r}: nvcc failed\n"
                               + log.read_text())
        regs[name] = next(r for inst, r, _ in cs.ptxas_instances(
            log.read_text()) if "kmeans_assign_kernelILi3E" in inst)
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump if cuobjdump.exists()
                               else shutil.which("cuobjdump")), "-sass",
                           str(jobs["as built"][0])], capture_output=True,
                          text=True, check=True).stdout
    start = sass.find("Function : _Z20kmeans_assign_kernelILi3E")
    loop = loop_opcodes(sass[start:sass.find("Function :", start + 1)])
    print(f"d = 3 scan's innermost loop: {sum(loop.values())} instructions "
          f"a group of {kernel.GROUP} centroids: {dict(loop.most_common())}")

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = autotune.DEFAULTS["kmeans"]
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for shape, (n, k) in km.PAPER_SCENARIOS.items():
        p = km.make_dataset(n, seed=1, device=dev)
        data[shape] = (p, p[torch.randperm(n, generator=gen, device=dev)[:k]]
                       .contiguous())
    rows = []
    for name, (path, _, _) in jobs.items():
        lib = ctypes.CDLL(str(path))
        lib.kmeans_assign_f32.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5)
        r = lib.kmeans_assign_rows(3)
        for shape, (p, c) in data.items():
            n, k = p.shape[0], c.shape[0]
            splits = ops.split_count(n, k, blocks["bn"], blocks["bk"], r, sms)
            idx = torch.empty(n, dtype=torch.int32, device=dev)
            dist = torch.empty(n, dtype=torch.float32, device=dev)
            part = (torch.empty((splits, n), dtype=torch.int32, device=dev),
                    torch.empty((splits, n), dtype=torch.float32, device=dev))

            def run():
                err = lib.kmeans_assign_f32(
                    p.data_ptr(), c.data_ptr(), n, k, 3, blocks["bn"],
                    blocks["bk"], splits, part[0].data_ptr(),
                    part[1].data_ptr(), idx.data_ptr(), dist.data_ptr(),
                    torch._C._cuda_getCurrentRawStream(0))
                cs.check(err == 0, f"probe {name!r}: launch error {err}")
            ms = cs.graph_ms(torch, run)
            rows.append({"probe": name, "shape": shape, "rows": r,
                         "splits": splits, "registers": regs[name],
                         "ms": ms})
            print(f"{name:18s} {shape:26s} R {r} splits {splits:3d} "
                  f"registers {regs[name]:3d}: {ms:.4f} ms")
    card = cs.card_line()
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "loop_opcodes": dict(loop), "rows": rows},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
