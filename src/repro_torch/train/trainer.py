"""Trainer: runs the end-to-end HPC stage.

The port of ``repro.train.trainer``.  Composes: sharding plan -> param
init -> train step -> data pipeline (prefetching) -> async
checkpointing -> fault recovery.  It runs as a gang-scheduled
Compute-Unit on a Pilot (``launch/train.py``,
``examples/torch_train_e2e.py``), taking the pilot's ``DeviceGrid`` of
any size, or standalone on a ``DeviceMesh`` inside a rank.

One code path for every grid: ``Plan.for_mesh`` places the parameters
and both AdamW moments as DTensors (FSDP over "data", TP over "model"),
the batch is split as ``Plan.batch_specs`` places it (each rank draws
the global batch from the pipeline and keeps its rows,
``parallel.context``), and the step runs the
sharded model (:mod:`repro_torch.sharding.parallel`) with
``act_spec=plan.act_spec()`` and ``moe_groups=plan.dp_size``.

Where the ranks live:
  * a one-device grid trains in this process, in a world-size-1 group
    (``launch.spmd.local_mesh``): ``state`` is the DTensor state, and
    ``run`` called again goes on from it;
  * a grid of more devices starts one process per device for each
    ``run`` (``launch.spmd.run``): each rank builds this trainer on its
    ``DeviceMesh`` from the state the caller holds (written once to a
    file that every rank maps), or restores, or initializes; it trains,
    and rank 0 alone gathers the state to the host and hands it back
    with the new history.  Between runs ``state`` is that full state,
    plain tensors on the CPU, so ``run`` again goes on from it.

Fault tolerance: ``run`` checkpoints every ``ckpt_every`` steps; after a
failure the caller shrinks the pilot, builds a new trainer on the
surviving grid and ``restore()``s: the per-leaf layout is the
reference's, so either package's checkpoint restores, onto any mesh.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import spmd
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, schedule
from repro_torch.sharding import Plan, parallel
from repro_torch.train.step import (abstract_train_state, make_train_state,
                                    make_train_step)
from repro_torch.util import tree_map

CPU = torch.device("cpu")


def _rank_run(mesh, cfg, kwargs, state_file, n_steps, start_step,
              log_every, inject_failure_at):
    """One rank of a multi-device run: train, then gather the state to
    rank 0 alone.  The state to start from is a file every rank maps
    (one host copy, the pages shared), placed leaf by leaf."""
    tr = Trainer(cfg, mesh, **kwargs)
    rank0 = mesh.get_rank() == 0
    if state_file is not None:
        tr.state = torch.load(state_file, mmap=True, weights_only=True)
    hist = tr.run(n_steps, start_step=start_step,
                  log_every=log_every if rank0 else 0,   # rank 0 reports
                  inject_failure_at=inject_failure_at)
    return hist, parallel.host_tree(tr.state, keep=rank0)


class Trainer:
    def __init__(self, cfg: ModelConfig, mesh, *,
                 global_batch: int = 8, seq: int = 128,
                 hyper: adamw.Hyper = adamw.Hyper(lr=1e-3),
                 n_microbatches: int = 1, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, seed: int = 0,
                 warmup_steps: int = 10, total_steps: int = 1000,
                 remat_policy: Optional[str] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.plan = Plan.for_mesh(mesh)
        self.global_batch = global_batch
        self.seq = seq
        self.seed = seed
        self.ckpt_every = ckpt_every
        self._kwargs = dict(global_batch=global_batch, seq=seq, hyper=hyper,
                            n_microbatches=n_microbatches, ckpt_dir=ckpt_dir,
                            ckpt_every=ckpt_every, seed=seed,
                            warmup_steps=warmup_steps,
                            total_steps=total_steps,
                            remat_policy=remat_policy)
        if hasattr(mesh, "mesh_dim_names"):         # inside a rank
            self.dmesh = mesh
        elif mesh.size == 1:                         # one device, inline
            self.dmesh = spmd.local_mesh(mesh)
        else:                                        # ranks per run()
            self.dmesh = None
        self.device = (spmd.mesh_device(self.dmesh) if self.dmesh is not None
                       else CPU)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self._step = make_train_step(
            cfg, hyper=hyper, n_microbatches=n_microbatches,
            act_spec=self.plan.act_spec(), moe_groups=self.plan.dp_size,
            remat_policy=remat_policy,
            lr_schedule=lambda s: schedule.warmup_cosine(
                s, warmup=warmup_steps, total=total_steps))
        self.state: Any = None
        self.pipeline = (TokenPipeline(cfg, batch=global_batch, seq=seq,
                                       seed=seed, device=self.device)
                         if self.dmesh is not None else None)
        self.history: List[Dict[str, float]] = []

    # -------------------------------------------------------------- state
    def _place(self, state: Any) -> Any:
        """A full train state as this mesh's DTensors (the plan's
        placements; ``step`` stays a plain scalar)."""
        return parallel.distribute_tree(
            state, self.plan.param_specs(state), self.dmesh, self.device)

    def init_state(self) -> None:
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        state = make_train_state(
            self.cfg, transformer.init_params(self.cfg, gen, device=dev))
        self.state = state if self.dmesh is None else self._place(state)

    def restore(self) -> int:
        """Restore the latest checkpoint onto this trainer's mesh (its
        own placements, whatever mesh wrote it).  Returns its step."""
        assert self.ckpt is not None
        target = abstract_train_state(self.cfg)
        if self.dmesh is None:
            self.state = self.ckpt.restore(target, device=CPU)
        else:
            self.state = self.ckpt.restore(target, device=self.device,
                                           mesh=self.dmesh, plan=self.plan)
        return int(self.state["step"])

    # ---------------------------------------------------------------- run
    def run(self, n_steps: int, *, start_step: Optional[int] = None,
            log_every: int = 10, inject_failure_at: Optional[int] = None,
            timeout: float = 3600.0) -> List[Dict[str, float]]:
        """Train up to step `n_steps`; returns the whole history.  On a
        grid of several devices the ranks must end within `timeout`
        seconds, else the call raises (and stops them)."""
        if self.dmesh is None:
            return self._run_ranks(n_steps, start_step, log_every,
                                   inject_failure_at, timeout)
        if self.state is None:
            if self.ckpt is not None and self.ckpt.latest_step() is not None:
                self.restore()
            else:
                self.init_state()
        elif not parallel.is_sharded(self.state["params"]):
            self.state = self._place(self.state)    # a state set by hand
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

    def _run_ranks(self, n_steps, start_step, log_every, inject_failure_at,
                   timeout):
        """One process per device of the grid for this run; the state
        goes to the ranks as one file and comes back gathered, plain
        tensors on the CPU."""
        with tempfile.TemporaryDirectory(prefix="repro-state-") as tmp:
            state_file = None
            if self.state is not None:
                state_file = os.path.join(tmp, "state.pt")
                torch.save(tree_map(lambda t: t.to(CPU), self.state),
                           state_file)
            hist, self.state = spmd.run(
                self.mesh, _rank_run, self.cfg, self._kwargs, state_file,
                n_steps, start_step, log_every, inject_failure_at,
                timeout=timeout)
        self.history.extend(hist)
        return self.history
