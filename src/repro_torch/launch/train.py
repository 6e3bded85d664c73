"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of ``repro.launch.train``.  Runs the reduced (smoke) config of
the selected architecture by default, the full one with
``--full-config``.  The training job executes as a gang-scheduled
Compute-Unit on a Pilot, on the card by default (``--device cpu`` runs
the same on the CPU).  The pilot holds ``--n-chips`` devices in a
(n / tp, tp) grid (``--tp``); the trainer shards over it (FSDP over
"data", TP over "model"), one process per device when there are more
than one (see ``train/trainer.py``): ``--n-chips 4 --tp 2 --device cpu``
trains on 4 gloo ranks.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

from repro_torch import configs
from repro_torch.core import (ComputeUnitDescription, PilotDescription,
                              PilotManager, ResourceManager)
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer
from repro_torch.util import Device, resolve_device


def train(cfg, *, steps: int, batch: int = 8, seq: int = 128,
          microbatches: int = 1, lr: float = 1e-3,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          warmup_steps: int = 10, total_steps: int = 1000,
          log_every: int = 10, device: Device = "cuda", n_chips: int = 1,
          tp: int = 1) -> Dict[str, Any]:
    """Start a Pilot of `n_chips` devices (a grid of `tp`-wide rows), run
    a Trainer for `steps` steps as a gang CU on it, shut the Pilot down.
    Returns the history, the trainer (its state on the device, or
    gathered on the CPU after a run of several ranks) and the pilot's and
    CU's overheads.  On the CPU the n chips are n slots of one device
    (n gloo ranks)."""
    device = resolve_device(device)
    pm = PilotManager(ResourceManager(
        devices=[device] * n_chips if device.type == "cpu" else None))
    try:
        pilot = pm.submit(PilotDescription(n_chips=n_chips, tp=tp,
                                           name=f"train-{cfg.name}"))
        print(f"pilot {pilot.uid} active on {len(pilot.devices)} chips "
              f"(startup {pilot.startup_s()*1e3:.1f} ms)")

        def job(mesh=None):
            trainer = Trainer(cfg, mesh, global_batch=batch, seq=seq,
                              hyper=adamw.Hyper(lr=lr),
                              n_microbatches=microbatches, ckpt_dir=ckpt_dir,
                              ckpt_every=ckpt_every,
                              warmup_steps=warmup_steps,
                              total_steps=total_steps)
            trainer.run(steps, log_every=log_every)
            return trainer

        cu = pilot.submit(ComputeUnitDescription(
            fn=job, n_chips=n_chips, gang=True, tag="train",
            memory_bytes=0))
        trainer = cu.wait(timeout=3600)
        return {"history": trainer.history, "trainer": trainer,
                "pilot_startup_s": pilot.startup_s(),
                "cu_overhead_s": cu.overhead_s()}
    finally:
        pm.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=configs.port_names())
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n-chips", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    args = ap.parse_args(argv)

    cfg = (configs.get(args.arch) if args.full_config
           else configs.get_smoke(args.arch))
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                microbatches=args.microbatches, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                device=args.device, n_chips=args.n_chips, tp=args.tp)
    history = out["history"]
    print(f"done: {len(history)} steps, final loss {history[-1]['loss']:.4f} "
          f"(CU overhead {out['cu_overhead_s']*1e3:.1f} ms)")
    return history


if __name__ == "__main__":
    main()
