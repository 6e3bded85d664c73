"""Trainer: runs the end-to-end HPC stage.

The port of ``repro.train.trainer``.  Composes: param init -> train step
-> data pipeline (prefetching) -> async checkpointing -> fault recovery.
It runs as a gang-scheduled Compute-Unit on a Pilot (``launch/train.py``,
``examples/torch_train_e2e.py``), taking the pilot's ``DeviceGrid``.

One device trains.  A grid of more devices raises: data and tensor
parallelism over a ``DeviceMesh`` wait for the sharding layer (ROADMAP
Queue 1, item 16).

Fault tolerance: ``run`` checkpoints every ``ckpt_every`` steps; after a
failure the caller builds a new trainer and ``restore()``s (the per-leaf
layout is the reference's, so either package's checkpoint restores).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, schedule
from repro_torch.train.step import (abstract_train_state, make_train_state,
                                    make_train_step)


def mesh_device(mesh) -> torch.device:
    """The one device of a pilot's ``DeviceGrid``; raises on more."""
    devices = list(mesh.devices.flat)
    if len(devices) != 1:
        raise NotImplementedError(
            f"training on {len(devices)} devices is not ported: a mesh of "
            "more than one device waits for the sharding layer "
            "(ROADMAP Queue 1, item 16: sharding/planner.py -> "
            "DeviceMesh/DTensor)")
    return torch.device(devices[0])


class Trainer:
    def __init__(self, cfg: ModelConfig, mesh, *,
                 global_batch: int = 8, seq: int = 128,
                 hyper: adamw.Hyper = adamw.Hyper(lr=1e-3),
                 n_microbatches: int = 1, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, seed: int = 0,
                 warmup_steps: int = 10, total_steps: int = 1000):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.global_batch = global_batch
        self.seq = seq
        self.seed = seed
        self.ckpt_every = ckpt_every
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self._step = make_train_step(
            cfg, hyper=hyper, n_microbatches=n_microbatches,
            lr_schedule=lambda s: schedule.warmup_cosine(
                s, warmup=warmup_steps, total=total_steps))
        self.state: Any = None
        self.pipeline = TokenPipeline(cfg, batch=global_batch, seq=seq,
                                      seed=seed, device=self.device)
        self.history: List[Dict[str, float]] = []

    # -------------------------------------------------------------- state
    def init_state(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state = make_train_state(
            self.cfg, transformer.init_params(self.cfg, gen,
                                              device=self.device))

    def restore(self) -> int:
        """Restore the latest checkpoint onto this trainer's device.
        Returns its step."""
        assert self.ckpt is not None
        self.state = self.ckpt.restore(abstract_train_state(self.cfg),
                                       device=self.device)
        return int(self.state["step"])

    # ---------------------------------------------------------------- run
    def run(self, n_steps: int, *, start_step: Optional[int] = None,
            log_every: int = 10, inject_failure_at: Optional[int] = None
            ) -> List[Dict[str, float]]:
        if self.state is None:
            if self.ckpt is not None and self.ckpt.latest_step() is not None:
                self.restore()
            else:
                self.init_state()
        step0 = (start_step if start_step is not None
                 else int(self.state["step"]))
        self.pipeline.start(from_step=step0)
        try:
            for i, batch in zip(range(step0, n_steps), self.pipeline):
                if inject_failure_at is not None and i == inject_failure_at:
                    raise RuntimeError("injected node failure")
                t0 = time.monotonic()
                self.state, metrics = self._step(self.state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["step"] = i
                metrics["step_s"] = time.monotonic() - t0
                self.history.append(metrics)
                if log_every and (i % log_every == 0 or i == n_steps - 1):
                    print(f"step {i:5d} loss {metrics['loss']:.4f} "
                          f"gnorm {metrics['grad_norm']:.3f} "
                          f"({metrics['step_s']*1e3:.0f} ms)")
                if (self.ckpt is not None and self.ckpt_every
                        and (i + 1) % self.ckpt_every == 0):
                    self.ckpt.save(self.state, i + 1)
        finally:
            self.pipeline.stop()
            if self.ckpt is not None:
                self.ckpt.wait()   # publish in-flight saves even on failure
        if self.ckpt is not None:
            self.ckpt.save(self.state, n_steps, blocking=True)
        return self.history
