#!/usr/bin/env python3
"""Probe what bounds K3's fused mode on the card: build altered copies of
``mamba_scan.cu`` and time the fused mode of each at the training and
Falcon-Mamba-7B shapes.

Run from the repository root on a machine with one CUDA card:

    python3 tools/k3_fused_probe.py [--out FILE.json] [--sass FILE]

Each probe changes one thing in a copy of the source (an anchor missing
from the source stops the script).  The layout probes keep the readout's
order and must give the built kernel's bits; the probes that leave work
out give wrong results, and only their time counts:

- ``as built``: no change;
- ``2 states a lane``: MSF_P 2, rows over twice the lanes (twice the
  warps);
- ``2 states a lane, groups of 8``: the same, 8 steps a readout group;
- ``groups of 2``: 2 steps a readout group (MSF_G 2);
- ``no exp``: a = 1 + dt A instead of expf;
- ``no readout``: the lane's own part stored, no shuffles;
- ``no y store``: y kept alive but not stored.

Each launch takes the rows that spread the blocks evenly over the SMs
(``mamba_scan.balanced_rows`` for the probe's lanes) and chunks of BS
steps.  It prints each probe's registers and spills (``-Xptxas -v``) and
at each shape its time (CUDA events, the least of two rounds of 20
calls), then the card's name and power limit.  ``--sass`` writes
``cuobjdump -sass`` of the built instance at 4 lanes a row, 4 states a
lane and BS-step chunks (d_state 16) to FILE.
"""
from __future__ import annotations

import argparse
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
BS = 64
P4 = "#define MSF_P 4 "
G4 = "#define MSF_G 4 "
DECAY = "  return expf(__fmul_rn(dt, A));"
READ = "    const float yv = rows_sum<L, G>(part, k);"
STORE = "    store_if(yq, yv, write && (!TAIL || t0 + g + tk < S));"
PROBES = {
    "as built": [],
    "2 states a lane": [(P4, "#define MSF_P 2 ")],
    "2 states a lane, groups of 8": [(P4, "#define MSF_P 2 "),
                                     (G4, "#define MSF_G 8 ")],
    "groups of 2": [(G4, "#define MSF_G 2 ")],
    "no exp": [(DECAY, "  return fmaf(dt, A, 1.f);")],
    "no readout": [(READ, "    const float yv = part[0];")],
    "no y store": [(STORE, "    store_if(yq, yv, yv == 1.2345e-38f);")],
}
BITWISE = ("as built", "2 states a lane", "2 states a lane, groups of 8",
           "groups of 2")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON file for the results")
    ap.add_argument("--sass", default=None,
                    help="file for the SASS of the 4-lane instance")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_fused_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import mamba_scan as ms_k
    card = cs.card_line()
    source = ms_k.SOURCE.read_text()
    out_dir = build.BUILD_DIR / "k3_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(PROBES.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"probe {name!r}: anchor {old!r} not in "
                                   "the source")
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
    inst = re.compile(rf"fusedILi(\d+)ELi(\d+)ELi{BS}E")
    for name, (lib, log, proc) in jobs.items():
        if proc.wait():
            raise RuntimeError(f"probe {name!r}: nvcc failed\n"
                               + log.read_text())
        regs = {f"lanes {m[1]} states {m[2]}": [r, sp]
                for n, r, sp in cs.ptxas_instances(log.read_text())
                if (m := inst.search(n))}
        print(f"{name}: registers, spill bytes at {BS}-step chunks {regs}")
    if args.sass:
        cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
        sass = subprocess.run(
            [str(cuobjdump if cuobjdump.exists()
                 else shutil.which("cuobjdump")), "-sass",
             str(jobs["as built"][0])], capture_output=True, text=True,
            check=True).stdout
        start = sass.find(f"Function : _Z23mamba_scan_kernel_fusedILi4ELi4ELi{BS}E")
        Path(args.sass).write_text(
            sass[start:sass.find("Function :", start + 1)])

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for label, B, S, di, st in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        f32 = dict(dtype=torch.float32, device=dev)
        dt = 0.005 + 0.5 * torch.rand(B, S, di, generator=g, **f32)
        A = -torch.arange(1, st + 1, **f32) * (
            0.5 + torch.rand(di, st, generator=g, **f32))
        u = dt * torch.randn(B, S, di, generator=g, **f32)
        Bc = torch.randn(B, S, st, generator=g, **f32)
        C = torch.randn(B, S, st, generator=g, **f32)
        h0 = torch.zeros(B, di, st, **f32)
        want = None
        for name, (path, _, _) in jobs.items():
            lib = ctypes.CDLL(str(path))
            fn = lib.mamba_scan_fused_fwd
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            lay = (ctypes.c_int * 4)()
            lib.mamba_scan_fused_layout.argtypes = [ctypes.c_int] * 3 + [
                ctypes.POINTER(ctypes.c_int)]
            cs.check(lib.mamba_scan_fused_layout(st, 4, BS, lay) == 0,
                     f"probe {name!r}: no layout")
            lanes = lay[0]
            stp = ms_k.state_lanes(st)
            # mamba_scan.balanced_rows for this probe's lanes
            rows_ = -(-B * di // sms)
            rows_ = min(-(-rows_ // 4) * 4, ms_k.MAX_THREADS // lanes,
                        (ms_k.FUSED_MAX_SMEM // 8 - 2 * BS * stp)
                        // (2 * BS) // 4 * 4)
            cs.check(lib.mamba_scan_fused_layout(st, rows_, BS, lay) == 0,
                     f"probe {name!r}: no layout at {rows_} rows")
            y = torch.empty(B, S, di, **f32)
            h = torch.empty(B, di, st, **f32)
            ptrs = [t.data_ptr() for t in (dt, A, u, Bc, C, h0, y, h)]

            def run():
                err = fn(*ptrs, B, S, di, st, rows_, BS,
                         torch.cuda.current_stream(dev).cuda_stream)
                cs.check(err == 0, f"probe {name!r}: launch error {err}")
            run()
            torch.cuda.synchronize()
            same = None
            if name in BITWISE:
                if want is None:
                    want = (y.clone(), h.clone())
                same = (torch.equal(y.view(torch.int32),
                                    want[0].view(torch.int32))
                        and torch.equal(h.view(torch.int32),
                                        want[1].view(torch.int32)))
            ms = min(cs.cuda_ms(torch, run), cs.cuda_ms(torch, run))
            blocks = -(-di // rows_) * B
            rows.append({"probe": name, "shape": label, "lanes": lanes,
                         "lane_states": lay[1], "rows": rows_,
                         "threads": lay[2], "blocks": blocks, "ms": ms,
                         "bitwise_as_built": same})
            print(f"  {label} {name}: {ms:.4f} ms; {lanes} lanes of "
                  f"{lay[1]} states, {blocks} blocks of {rows_} rows "
                  f"({lay[2]} threads)"
                  + ("" if same is None else f"; bits as built: {same}"))
        del dt, A, u, Bc, C, h0
        torch.cuda.empty_cache()
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
