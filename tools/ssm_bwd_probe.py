#!/usr/bin/env python3
"""Probe what bounds the fused backward of the Mamba scan and its input
tail on the card: build altered copies of ``mamba_ssm_bwd.cu`` and time
each at the training and Falcon-Mamba-7B shapes.

Run from the repository root on a machine with one CUDA card:

    python3 tools/ssm_bwd_probe.py [--out FILE.json]

Each probe changes one thing in a copy of the source (an anchor that is
missing from the source stops the script); the probes that leave work out
give wrong results, and only their time counts:

- ``as built``: no change;
- ``no exp``: a = 1 + dt A instead of expf (the SFU and expf's FP32
  work gone);
- ``__expf``: the fast exp (ex2.approx of a scaled product);
- ``no row sums``: the shuffles over a row's lanes (ddt, du) and over the
  warp's rows (dBc, dC) left out;
- ``no cluster sum``: the cross-block sum through distributed shared
  memory left out (the cluster barriers stay);
- ``no forward walk``: pass 1 (h's checkpoints) left out;
- ``T = 8``: chunks of 8 steps;
- ``T = 8, a kept``: chunks of 8 steps, and the rebuild keeps a_t in
  registers for the reverse step instead of a third exp;
- ``2 states a lane``: rows over twice the lanes, twice the blocks;
- ``2 states a lane, 7 blocks an SM``: the same with registers capped for
  7 blocks of 128 threads an SM (72 a thread).

For each probe it prints the registers and spills of its instances
(``-Xptxas -v``), and at each shape the launch layout, the blocks resident
an SM, the clusters resident at once (the CUDA occupancy calculator), the
waves the grid needs, and the time (CUDA events, 20 calls after 3).  From
``cuobjdump -sass`` of the build as it is, it counts the instructions of
the two chunk loops (forward walk, backward walk) of the instance the
shape runs; times the loops' trips and the warps this is the dynamic
count (an upper bound: tile copies that a thread skips are counted), and
with the SM clock sampled while the kernel runs, the instructions issued
a clock an SM (4 is the most an SM issues).  Then the card's name and
power limit.
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

SHAPES = (("hymba-1.5b train", 4, 2048, 3200, 16),
          ("falcon-mamba-7b", 1, 2048, 8192, 16))
DECAY = "  return expf(__fmul_rn(dt, A));"
ROW_SUMS = ("          ddt_p += __shfl_xor_sync(0xffffffffu, ddt_p, o);\n"
            "          du_p += __shfl_xor_sync(0xffffffffu, du_p, o);")
ROWS = "        sum_rows<L, V, V, 1>(v, g);"
FLUSH = "      flush(c + 1);"
PASS1 = "  for (int c = 0; c < nc - 1; ++c) {"
CHUNK = "#define MSS_T 16 "
HB = "    float hb[MSS_T][P];"
REBUILD = ("          hh[j] = fmaf(decay(dtv, Ar[j]), hh[j], "
           "__fmul_rn(uv, bv[j]));")
CARRY = "          carry[j] = decay(dtv, Ar[j]) * gj;"
LANE = "#define MSS_P 4\n"
MINB = "#define MSS_MINB 4\n"
PROBES = {
    "as built": [],
    "no exp": [(DECAY, "  return fmaf(dt, A, 1.f);")],
    "__expf": [(DECAY, "  return __expf(__fmul_rn(dt, A));")],
    "no row sums": [(ROW_SUMS, ""), (ROWS, "")],
    "no cluster sum": [(FLUSH, "")],
    "no forward walk": [(PASS1, PASS1.replace("c < nc - 1", "c < 0"))],
    "T = 8": [(CHUNK, "#define MSS_T 8 ")],
    "T = 8, a kept": [
        (CHUNK, "#define MSS_T 8 "),
        (HB, "    float hb[MSS_T][P], ra[MSS_T][P];"),
        (REBUILD, "          ra[i][j] = decay(dtv, Ar[j]);\n"
                  "          hh[j] = fmaf(ra[i][j], hh[j], "
                  "__fmul_rn(uv, bv[j]));"),
        (CARRY, "          carry[j] = ra[i][j] * gj;")],
    "2 states a lane": [(LANE, "#define MSS_P 2\n")],
    "2 states a lane, 7 blocks an SM": [(LANE, "#define MSS_P 2\n"),
                                        (MINB, "#define MSS_MINB 7\n")],
}


def sass_loops(sass: str) -> list:
    """The bodies (opcode counters) of the chunk loops: the outer loops (a
    backward branch's range, not inside a larger one) that hold 16 MUFU or
    more (a chunk's exps; a tile loop's integer division holds one)."""
    ins = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                     r"\s*([^;]*);", line)
        if m:
            ins.append((int(m[1], 16), m[3].split(".")[0], m[4]))
    ranges = []
    for addr, op, args in ins:
        target = re.match(r"(0x[0-9a-f]+)", args.strip())
        if op == "BRA" and target and int(target[1], 16) < addr:
            ranges.append((int(target[1], 16), addr))
    outer = [r for r in ranges if not any(
        o[0] <= r[0] and r[1] <= o[1] and o != r for o in ranges)]
    bodies = []
    for lo, hi in sorted(outer):
        body = collections.Counter(op for a, op, _ in ins if lo <= a <= hi)
        if body["MUFU"] >= 16:
            bodies.append(body)
    return bodies


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssm_bwd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import mamba_scan as ms_k
    from repro_torch.launch import platform

    platform.configure("cuda")
    card = cs.card_line()
    source = ms_k.SSM_BWD_SOURCE.read_text()
    out_dir = build.BUILD_DIR / "ssm_probe"
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
    inst = re.compile(r"mamba_ssm_bwd_kernelILi(\d+)ELi(\d+)E")
    regs = {}
    for name, (lib, log, proc) in jobs.items():
        if proc.wait():
            raise RuntimeError(f"probe {name!r}: nvcc failed\n"
                               + log.read_text())
        regs[name] = {f"lanes {m[1]} states {m[2]}": [r, sp]
                      for n, r, sp in cs.ptxas_instances(log.read_text())
                      if (m := inst.search(n))}
        print(f"{name}: registers, spill bytes {regs[name]}")
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump if cuobjdump.exists()
                               else shutil.which("cuobjdump")), "-sass",
                           str(jobs["as built"][0])], capture_output=True,
                          text=True, check=True).stdout

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(7)
    rows, loops = [], {}
    for label, B, S, di, st in SHAPES:
        x = cs.ssm_bwd_inputs(torch, gen, dev, B, S, di, st)
        outs = [torch.empty_like(t) for t in (x[0], x[2], x[3], x[4], x[1],
                                              x[5])]
        for name, (path, _, _) in jobs.items():
            lib = ctypes.CDLL(str(path))
            lib.mamba_ssm_bwd.argtypes = [ctypes.c_void_p] * 17 \
                + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            for fn in ("mamba_ssm_bwd_layout", "mamba_ssm_bwd_occupancy"):
                getattr(lib, fn).argtypes = [ctypes.c_int] * 2 + [
                    ctypes.POINTER(ctypes.c_int)]
            lay, occ = (ctypes.c_int * 7)(), (ctypes.c_int * 2)()
            cs.check(lib.mamba_ssm_bwd_layout(di, st, lay) == 0
                     and lib.mamba_ssm_bwd_occupancy(di, st, occ) == 0,
                     f"probe {name!r}: layout or occupancy refused")
            T = lib.mamba_ssm_bwd_chunk()
            threads = lib.mamba_ssm_bwd_threads()
            hck = torch.empty((B, -(-S // T), di, st), device=dev)
            part = torch.empty((B, S, lay[3], 2 * lay[5]), device=dev)
            dA_part = torch.empty((B, di, st), device=dev)
            ptrs = [t.data_ptr() for t in (*x, *outs, hck, part, dA_part)]

            def run():
                err = lib.mamba_ssm_bwd(
                    *ptrs, B, S, di, st,
                    torch.cuda.current_stream(dev).cuda_stream)
                cs.check(err == 0, f"probe {name!r}: launch error {err}")
            ms = cs.cuda_ms(torch, run)
            blocks = lay[1] * B
            waves = max(blocks / (occ[0] * sms), blocks / lay[2] / occ[1])
            row = {"probe": name, "shape": label, "chunk": T,
                   "lane_states": lay[6], "rows": lay[0], "blocks": blocks,
                   "cluster": lay[2], "blocks_per_sm": occ[0],
                   "resident_clusters": occ[1], "waves": waves,
                   "registers": regs[name], "ms": ms}
            extra = ""
            if name == "as built":
                lanes = lay[5] // lay[6]
                start = sass.find("Function : _Z20mamba_ssm_bwd_kernelILi"
                                  f"{lanes}ELi{lay[6]}E")
                bodies = sass_loops(
                    sass[start:sass.find("Function :", start + 1)])
                loops[label] = [dict(b.most_common()) for b in bodies]
                print(f"  {label}: chunk loops (lanes {lanes}): " + "; ".join(
                    f"{sum(b.values())} instructions "
                    f"{dict(b.most_common(12))}" for b in bodies))
                for _ in range(int(1000 / ms)):   # ~1 s queued on the card
                    run()
                row["sm_clock_mhz"] = sm_clock_mhz()
                torch.cuda.synchronize()
                if len(bodies) == 2:
                    nc = -(-S // T)
                    dyn = blocks * threads // 32 * (
                        (nc - 1) * sum(bodies[0].values())
                        + nc * sum(bodies[1].values()))
                    row["warp_instructions"] = dyn
                    row["issued_a_clock_an_sm"] = dyn / (
                        1e-3 * ms * 1e6 * row["sm_clock_mhz"] * sms)
                    extra = (f"; at most {dyn / 1e6:.1f} M warp "
                             f"instructions, {row['issued_a_clock_an_sm']:.2f}"
                             f" a clock an SM at {row['sm_clock_mhz']:.0f} "
                             "MHz")
            rows.append(row)
            print(f"{name:32s} {label:17s} T {T:2d}, {lay[6]} states a lane, "
                  f"{blocks} blocks of {lay[0]} rows, clusters of {lay[2]}; "
                  f"{occ[0]} blocks an SM, {occ[1]} clusters resident, "
                  f"{waves:.2f} waves: {ms:.4f} ms{extra}")
        del x, outs
        torch.cuda.empty_cache()
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "loops": loops, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
