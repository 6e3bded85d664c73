#!/usr/bin/env python3
"""Measure the card's mma.sync rate: the ceiling of K2's tensor-core path.

Run from the repository root on a machine with one CUDA card:

    python3 tools/mma_rate.py

Builds ``tools/mma_rate.cu`` with the port's nvcc recipe, launches it
with 4 warps per block and 1 to 4 blocks per SM, and prints for each
product (m16n8k8 TF32, m16n8k16 bf16) the best rate in TFLOP/s, the
3xTF32 rate (a third of the TF32 one) and the card's name and power
limit.  Dense data-sheet peaks (H100 SXM, wgmma): 495 TFLOP/s TF32, 989
bf16.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device is available", file=sys.stderr)
        return 1
    lib = build.load(Path(__file__).resolve().with_suffix(".cu"))
    lib.mma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mma_rate.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 128, 4096
    flops_per_mma = {"tf32 m16n8k8": 2 * 16 * 8 * 8,
                     "bf16 m16n8k16": 2 * 16 * 8 * 16}
    out = torch.empty(4 * sms * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for kind, (name, fl) in enumerate(flops_per_mma.items()):
        best = 0.0
        for per_sm in (1, 2, 3, 4):
            blocks = per_sm * sms

            def launch():
                err = lib.mma_rate(kind, out.data_ptr(), blocks, threads,
                                   iters, stream)
                if err:
                    raise RuntimeError(f"mma_rate launch failed: {err}")
            launch()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                launch()
            end.record()
            torch.cuda.synchronize()
            s = start.elapsed_time(end) / 5 / 1e3
            rate = blocks * threads // 32 * iters * 8 * fl / s / 1e12
            print(f"{name}: {per_sm} blocks of 4 warps per SM: {rate:.2f} "
                  "TFLOP/s")
            best = max(best, rate)
        result[name] = best
    result["3xtf32 (a third of tf32)"] = result["tf32 m16n8k8"] / 3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"mma_sync_tflops": result, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
