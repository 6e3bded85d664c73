#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card and set-up: the card's name and power limit, torch and CUDA
     versions, and the build of every kernel from ``csrc/`` with nvcc;
  2. every kernel against its plain PyTorch version at the main path's
     shapes (plus ragged, bf16, wide and tie cases), then timed beside
     its bound, its plain version and one library call;
  3. the main path: ResourceManager -> PilotManager -> Pilot ->
     spawn_analytics_cluster -> AnalyticsEngine -> kmeans_fit on the
     paper's three K-Means scenarios at full size, both data paths,
     then one K-Means as a gang CU through the Agent;
  4. a torch.profiler breakdown of one main-path run per scenario.

The second-to-last lines are the ``{"kernels": ...}`` record and the
card line; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: FP32 (non-tensor) peak and HBM3 bandwidth
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

ITERS = 2          # the paper's K-Means iterations
REPS = 5           # main-path repetitions per scenario and path
TIMED_LAUNCHES = 20


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = TIMED_LAUNCHES) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events, after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def assign_bound(n: int, k: int, d: int) -> dict:
    """Least time for one assignment on the card: each input read once
    and each output written once, or k*(d+1) FMAs (2 FLOPs each) per
    point at the FP32 peak — whichever is larger."""
    nbytes = 4 * (n * d + k * d) + 8 * n
    flops = 2 * n * k * (d + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bytes": nbytes, "flops": flops, "t_bytes": t_bytes,
            "t_ops": t_ops}


def compare_assign(torch, ops, ref, p, c, label: str) -> float:
    """Kernel vs plain version on the same inputs; returns max |err|."""
    ik, dk = ops.assign(p, c)
    ir, dr = ref.assign(p, c)
    torch.cuda.synchronize()
    same = (ik == ir).float().mean().item()
    err = (dk - dr).abs()
    tol = 1e-3 + 1e-4 * dr.abs()
    check(bool(torch.isfinite(dk).all()), f"{label}: non-finite distances")
    check(same >= 0.999, f"{label}: index agreement {same:.5f} < 0.999")
    check(bool((err <= tol).all()),
          f"{label}: distance error {err.max().item():.3e} over "
          "rtol 1e-4 / atol 1e-3")
    print(f"  {label}: n={p.shape[0]} k={c.shape[0]} d={p.shape[1]} "
          f"{p.dtype}: index agreement {same:.6f}, max |err| "
          f"{err.max().item():.3e}")
    return err.max().item()


def first_iteration_flips(torch, km_kernel, ref, pts, centroids) -> int:
    """Points the kernel and the plain version assign differently from
    the same centroids.  Each must be a tie by distance: the two
    choices' float64 squared distances agree within the comparison's
    tolerance (atol 1e-3, rtol 1e-4).  Uses the bare launcher, so these
    comparison launches stay out of the wrapper's launch count."""
    n = pts.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=pts.device)
    part = torch.empty(n, dtype=torch.float32, device=pts.device)
    km_kernel.assign_cuda(pts, centroids, idx, part)
    plain_idx, _ = ref.assign(pts, centroids)
    diff = (idx != plain_idx).nonzero()[:, 0]
    p64 = pts[diff].double()
    d_k = ((p64 - centroids[idx[diff].long()].double()) ** 2).sum(1)
    d_p = ((p64 - centroids[plain_idx[diff].long()].double()) ** 2).sum(1)
    check(bool(((d_k - d_p).abs() <= 1e-3 + 1e-4 * d_p).all()),
          "a first-iteration disagreement is not a tie by distance")
    return int(diff.numel())


def profile_fit(torch, km, eng, name: str, k: int) -> dict:
    """One local kmeans_fit under torch.profiler: wall time, device busy
    time (summed self device time of every kernel; one stream, so they
    do not overlap) and the heaviest operators by device time."""
    from torch.profiler import ProfilerActivity, profile
    km.kmeans_fit(eng, name, k, iters=ITERS, use_kernel=True)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        km.kmeans_fit(eng, name, k, iters=ITERS, use_kernel=True)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    # device-side entries (kernels, copies, memsets) only: an operator's
    # own entry repeats the device time of the kernels it launched
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host_ops = [e for e in events if e.device_type == DeviceType.CPU]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "top_device_ms": {e.key[:72]: dev_us(e) / 1e3 for e in
                             sorted(kernels, key=dev_us, reverse=True)[:6]},
           "top_cpu_ms": {e.key[:72]: e.self_cpu_time_total / 1e3 for e in
                          sorted(host_ops, key=lambda e: e.self_cpu_time_total,
                                 reverse=True)[:6]}}
    share = (f"{100 * busy_ms / wall_ms:.1f} %" if busy_ms
             else "not measured (no device events)")
    print(f"  {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({share})")
    for key, ms in out["top_device_ms"].items():
        print(f"    device {ms:9.4f} ms  {key}")
    for key, ms in out["top_cpu_ms"].items():
        print(f"    host   {ms:9.4f} ms  {key}")
    return out


def numpy_lloyd(pts, init, iters: int) -> float:
    """Plain numpy K-Means (float64), independent of the port's code."""
    import numpy as np
    c = init.astype(np.float64)
    x = pts.astype(np.float64)
    cost = math.inf
    for _ in range(iters):
        d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        a = d2.argmin(1)
        cost = d2[np.arange(len(x)), a].sum()
        for j in range(len(c)):
            if (a == j).any():
                c[j] = x[a == j].mean(0)
    return float(cost)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.analytics import kmeans as km
    from repro_torch.analytics.engine import AnalyticsEngine
    from repro_torch.core import (ComputeUnitDescription, CUState, Link,
                                  PilotDescription, PilotManager,
                                  ResourceManager)
    from repro_torch.kernels import build
    from repro_torch.kernels.kmeans import kmeans as km_kernel
    from repro_torch.kernels.kmeans import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ------------------------------------------------- 1. card and set-up
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    build_s = build.build_all([km_kernel.SOURCE])
    print(f"kernel build: {build_s:.2f} s")
    for line in build.build_log(km_kernel.SOURCE).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ------------------------------------- 2. kernel against plain version
    print("phase 2: kmeans_assign against its plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    shapes = []
    for name, (n, k) in km.PAPER_SCENARIOS.items():
        p = km.make_dataset(n, seed=1, device=dev)
        c = p[torch.randperm(n, generator=gen, device=dev)[:k]].contiguous()
        max_err = max(max_err, compare_assign(torch, ops, ref, p, c, name))
        bound = assign_bound(n, k, km.PAPER_DIM)
        # kernel, plain, library, kernel, plain: in turns on one card
        t_kernel = cuda_ms(torch, lambda: ops.assign(p, c))
        t_plain = cuda_ms(torch, lambda: ref.assign(p, c))
        t_lib = cuda_ms(torch, lambda: torch.cdist(p, c).min(dim=1))
        t_kernel = min(t_kernel, cuda_ms(torch, lambda: ops.assign(p, c)))
        t_plain = min(t_plain, cuda_ms(torch, lambda: ref.assign(p, c)))
        # the bare launch, without the wrapper's checks and |p|^2 epilogue
        idx_out = torch.empty(n, dtype=torch.int32, device=dev)
        min_out = torch.empty(n, dtype=torch.float32, device=dev)
        t_bare = cuda_ms(torch, lambda: km_kernel.assign_cuda(
            p, c, idx_out, min_out))
        shapes.append({"shape": name, "n": n, "k": k, "d": km.PAPER_DIM,
                       "ms": t_kernel, "kernel_only_ms": t_bare,
                       "plain_ms": t_plain, "library_ms": t_lib,
                       "bound_ms": 1e3 * max(bound["t_bytes"], bound["t_ops"]),
                       "bound_by": ("bytes" if bound["t_bytes"]
                                    >= bound["t_ops"] else "operations"),
                       "bytes": bound["bytes"], "flops": bound["flops"]})
        print(f"  {name}: kernel {t_kernel:.4f} ms (bare launch "
              f"{t_bare:.4f} ms), plain {t_plain:.4f} ms, "
              f"cdist+min {t_lib:.4f} ms, bound {shapes[-1]['bound_ms']:.4f}"
              f" ms ({shapes[-1]['bound_by']})")
    ragged_p = torch.randn(10_007, 3, generator=gen, device=dev)
    ragged_c = torch.randn(517, 3, generator=gen, device=dev)
    max_err = max(max_err, compare_assign(torch, ops, ref, ragged_p,
                                          ragged_c, "ragged"))
    bf_p = torch.randn(4_099, 3, generator=gen, device=dev).bfloat16()
    bf_c = torch.randn(300, 3, generator=gen, device=dev).bfloat16()
    max_err = max(max_err, compare_assign(torch, ops, ref, bf_p, bf_c,
                                          "bf16"))
    wide_p = torch.randn(2_000, 16, generator=gen, device=dev)
    wide_c = torch.randn(100, 16, generator=gen, device=dev)
    max_err = max(max_err, compare_assign(torch, ops, ref, wide_p, wide_c,
                                          "wide"))
    base = torch.randn(40, 3, generator=gen, device=dev)
    tie_c = torch.cat([base, base, base]).contiguous()  # every centroid x3
    tie_p = torch.randn(5_000, 3, generator=gen, device=dev)
    max_err = max(max_err, compare_assign(torch, ops, ref, tie_p, tie_c,
                                          "tie"))
    tie_idx, _ = ops.assign(tie_p, tie_c)
    check(bool((tie_idx < base.shape[0]).all()),
          "tie: a duplicate centroid did not resolve to its first index")

    # --------------------------------------------------------- 3. main path
    print("phase 3: main path (Pilot -> Mode-I cluster -> kmeans_fit)")
    pm = PilotManager(ResourceManager())
    try:
        pilot = pm.submit(PilotDescription(n_chips=1, name="hpc"))
        check(pilot.agent.lrm.info()["platform"] == "gpu",
              "pilot is not on the GPU")
        cluster = pilot.spawn_analytics_cluster(1)
        eng = cluster.engine
        home = cluster.devices[0]
        # checks first, so that their launches stay out of the main
        # path's count: kernel vs plain version through kmeans_fit.  One
        # iteration starts from the same centroids, so the costs differ
        # only by rounding (rel 1e-4).  After two they agree to rel 1e-4
        # unless a first-iteration near-tie went the other way: both
        # choices are right, but at k = 5000 a cluster holds ~2 points
        # and one flip moves its centroid visibly.
        plain_costs = {}
        for s, (name, (n, k)) in enumerate(km.PAPER_SCENARIOS.items()):
            eng.put(name, km.make_dataset(n, seed=10 + s, device=home))
            flips = first_iteration_flips(
                torch, km_kernel, ref, eng.get(name).full(),
                km._init_centroids(eng.get(name), k, 0))
            one = [km.kmeans_fit(eng, name, k, iters=1, use_kernel=uk)[1]
                   for uk in (True, False)]
            check(math.isclose(one[0], one[1], rel_tol=1e-4),
                  f"{name}: 1-iteration kernel cost {one[0]} vs plain "
                  f"{one[1]}")
            plain_costs[name] = (km.kmeans_fit(
                eng, name, k, iters=ITERS, use_kernel=False)[1], flips)
            print(f"  {name}: 1-iteration kernel vs plain cost rel diff "
                  f"{abs(one[0] - one[1]) / one[1]:.3e}; {flips} "
                  "first-iteration near-tie flips")
        # independent numpy reference on a small input
        eng.put("small", km.make_dataset(2_048, seed=7, device=home))
        init = km._init_centroids(eng.get("small"), 5, 0)
        _, small_cost = km.kmeans_fit(eng, "small", 5, iters=ITERS,
                                      use_kernel=True)
        np_cost = numpy_lloyd(eng.get("small").to_numpy(),
                              init.cpu().numpy(), ITERS)
        check(math.isclose(small_cost, np_cost, rel_tol=1e-4),
              f"small: kernel cost {small_cost} vs numpy {np_cost}")
        print(f"  small (2048 x 5): cost {small_cost:.6e}, numpy "
              f"{np_cost:.6e}")

        walls = {}
        ops.LAUNCHES = 0                       # the main path's window
        for name, (n, k) in km.PAPER_SCENARIOS.items():
            n_blocks = len(eng.get(name).row_blocks())
            costs = {}
            for path in ("local", "global"):
                times = []
                for _ in range(REPS):
                    gfs0 = eng.data.moved_by_link(Link.GFS)
                    before = ops.LAUNCHES
                    t0 = time.perf_counter()
                    cent, cost = km.kmeans_fit(eng, name, k, iters=ITERS,
                                               data_path=path,
                                               use_kernel=True)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    check(ops.LAUNCHES - before == ITERS * n_blocks,
                          f"{name}/{path}: {ops.LAUNCHES - before} kernel "
                          f"launches, want {ITERS * n_blocks}")
                    gfs = eng.data.moved_by_link(Link.GFS) - gfs0
                    want = (2 * ITERS * eng.get(name).nbytes
                            if path == "global" else 0)
                    check(gfs == want, f"{name}/{path}: {gfs} GFS bytes, "
                          f"want {want}")
                    check(tuple(cent.shape) == (k, km.PAPER_DIM)
                          and bool(torch.isfinite(cent).all())
                          and math.isfinite(cost),
                          f"{name}/{path}: bad centroids or cost")
                costs[path] = cost
                walls[(name, path)] = statistics.median(times)
                print(f"  {name} {path}: cost {cost:.6e}, median wall "
                      f"{1e3 * walls[(name, path)]:.3f} ms over {REPS}")
            check(math.isclose(costs["local"], costs["global"], rel_tol=1e-5),
                  f"{name}: local {costs['local']} != global "
                  f"{costs['global']}")
            plain_cost, flips = plain_costs[name]
            rel = abs(costs["local"] - plain_cost) / plain_cost
            check(flips > 0 or rel <= 1e-4,
                  f"{name}: kernel cost {costs['local']} vs plain "
                  f"{plain_cost}")
            print(f"  {name}: kernel vs plain cost rel diff {rel:.3e} after "
                  f"{ITERS} iterations")
        cluster.shutdown()

        def gang_kmeans(mesh=None):
            g_eng = AnalyticsEngine(mesh, pilot.data)
            g_eng.put("gang-pts", km.make_dataset(
                100_000, seed=3, device=mesh.devices.flat[0]))
            return km.kmeans_fit(g_eng, "gang-pts", 500, iters=ITERS,
                                 use_kernel=True)[1]

        before = ops.LAUNCHES
        cu = pilot.submit(ComputeUnitDescription(
            fn=gang_kmeans, n_chips=1, gang=True, needs_mesh=True,
            tag="kmeans-gang"))
        gang_cost = cu.wait(600)
        check(cu.state is CUState.DONE and math.isfinite(gang_cost),
              f"gang CU ended {cu.state} with {gang_cost!r}")
        check(ops.LAUNCHES - before == ITERS,
              f"gang CU: {ops.LAUNCHES - before} launches, want {ITERS}")
        print(f"  gang CU {cu.uid}: cost {gang_cost:.6e}")
        launches = ops.LAUNCHES

        # ------------------------------------- 4. where the time goes
        print("phase 4: profile of one local kmeans_fit per scenario")
        eng = pilot.spawn_analytics_cluster(1).engine
        breakdown = {name: profile_fit(torch, km, eng, name, k)
                     for name, (_, k) in km.PAPER_SCENARIOS.items()}
    finally:
        pm.shutdown()

    check(launches > 0, "the main path launched no kmeans_assign kernel")
    t_bytes = sum(s["bytes"] for s in shapes) / HBM_BYTES_PER_S
    t_ops = sum(s["flops"] for s in shapes) / FP32_FLOP_PER_S
    record = {"kernels": [{
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/kmeans/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans/kmeans.py:47",
        "launches": launches, "max_abs_err": max_err,
        # one call at each of the paper's three shapes, summed
        "ms": sum(s["ms"] for s in shapes),
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(s["library_ms"] for s in shapes),
        "shapes": shapes,
    }], "main_path_wall_ms": {f"{n}/{p}": 1e3 * t
                              for (n, p), t in walls.items()},
        "profile": breakdown, "build_s": build_s}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
