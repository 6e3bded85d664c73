"""Batched serving example on the PyTorch port: prefill + greedy decode of
a small model on a pilot, reporting prefill latency and decode
throughput.  Runs on the card; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/torch_serve_batch.py --arch internvl2-2b
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core import (ComputeUnitDescription, PilotDescription,
                              PilotManager, ResourceManager)
from repro_torch.launch.serve import serve_batch
from repro_torch.util import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=configs.names())
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    cfg = configs.get_smoke(args.arch)
    device = resolve_device(args.device)
    pm = PilotManager(ResourceManager(
        devices=[device] if device.type == "cpu" else None))
    try:
        pilot = pm.submit(PilotDescription(n_chips=1, name="serve"))
        cu = pilot.submit(ComputeUnitDescription(
            fn=lambda mesh=None: serve_batch(
                cfg, n_requests=args.requests, prompt_len=args.prompt_len,
                gen=args.gen, device=mesh.devices.flat[0]),
            gang=True, n_chips=1, tag="serve"))
        res = cu.wait(600)
    finally:
        pm.shutdown()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"{args.arch} on {name}: {args.requests} requests, prompt "
          f"{args.prompt_len}, gen {args.gen}")
    print(f"  prefill {res['prefill_s']*1e3:.0f} ms | decode "
          f"{res['decode_s']*1e3:.0f} ms | {res['tok_per_s']:.1f} tok/s")
    print(f"  sample tokens: {res['tokens'][0][:8].tolist()}")


if __name__ == "__main__":
    main()
