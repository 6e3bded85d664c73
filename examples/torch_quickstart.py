"""Quickstart on the port: the Pilot-Abstraction in ~50 lines.  The
PyTorch counterpart of ``examples/quickstart.py``; on the visible CUDA
devices by default (it raises without them):

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. Acquire a Pilot (placeholder allocation) from the resource manager.
2. Submit fine-grained Compute-Units (Hadoop-style bin packing).
3. Submit a gang-scheduled HPC Compute-Unit (one PyTorch computation on
   the pilot's device).
4. Mode I: carve an analytics cluster out of the pilot, run one
   MapReduce round, give the chips back.
"""
import argparse

import torch

from repro_torch.core import (ComputeUnitDescription, PilotDescription,
                              PilotManager, ResourceManager)


def hpc_stage(mesh=None):
    """Sum of squares of arange(1024) in f32 on the CU's first device."""
    x = torch.arange(1024, dtype=torch.float32, device=mesh.devices.flat[0])
    return float((x ** 2).sum())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    # the CUDA pool is every visible card (ResourceManager raises without
    # one); the CPU only when asked for
    rm = (ResourceManager(devices=[torch.device("cpu")])
          if args.device == "cpu" else ResourceManager())
    pm = PilotManager(rm)
    try:
        pilot = pm.submit(PilotDescription(n_chips=1, name="quickstart"))
        startup_ms = pilot.startup_s() * 1e3
        print(f"[1] pilot {pilot.uid} ACTIVE on {len(pilot.devices)} chip(s) "
              f"({pilot.agent.lrm.info()['platform']}) in {startup_ms:.3f} ms")

        # -- fine-grained data-parallel tasks (the 'Hadoop' shape) ---------
        cus = [pilot.submit(ComputeUnitDescription(
            fn=lambda i=i, mesh=None: i * i, tag="map", needs_mesh=False))
            for i in range(8)]
        maps = [cu.wait(30) for cu in cus]
        print("[2] map results:", maps)

        # -- a gang-scheduled HPC stage (one computation on its devices) ---
        cu = pilot.submit(ComputeUnitDescription(
            fn=hpc_stage, gang=True, n_chips=1, tag="hpc"))
        hpc = cu.wait(60)
        overhead_ms = cu.overhead_s() * 1e3
        print(f"[3] HPC stage -> {hpc:.3e} "
              f"(CU overhead {overhead_ms:.3f} ms)")

        # -- Mode I: on-demand analytics cluster inside the allocation ----
        cluster = pilot.spawn_analytics_cluster(1)
        cluster.engine.put("xs", torch.arange(4096, dtype=torch.float32)
                           .reshape(-1, 1))
        total = float(cluster.engine.map_reduce(lambda blk: blk.sum(), "xs"))
        print(f"[4] Mode-I analytics cluster (spawn "
              f"{cluster.startup_s * 1e3:.3f} ms) map_reduce sum = "
              f"{total:.0f}")
        cluster.shutdown()
    finally:
        pm.shutdown()
    print("done.")
    return {"maps": maps, "hpc": hpc, "sum": total,
            "startup_ms": startup_ms, "overhead_ms": overhead_ms}


if __name__ == "__main__":
    main()
