"""Data parallelism ACROSS pilots with compressed gradient exchange.

The port of ``repro.train.multi_pilot``.  One model trains over several
Pilots that do not share a mesh: each pilot computes gradients for its
slice of the global batch as a gang CU; the coordinator averages them
over the slow inter-pilot link, plain (f32) or int8 with error feedback
(:func:`repro_torch.optim.compression.ef_quantize`, one scale a leaf),
counts the wire bytes as the reference counts them, reports them to the
DataPlane ledger over ``Link.DCN`` and applies one AdamW step a round.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import ComputeUnitDescription, Pilot
from repro_torch.core.dataplane import DataPlane, Link
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compression
from repro_torch.train.step import value_and_grad
from repro_torch.util import tree_leaves, tree_map


class MultiPilotTrainer:
    """Cross-pilot data-parallel trainer; a Session client.

    When given a ``session`` (or a ``dataplane``), the trainer draws its
    pilots from the Session's HPC-runtime pilots and reports every
    gradient-exchange wire byte to the shared DataPlane ledger over the
    inter-pilot DCN link.  The coordinator's params live on the first
    pilot's first device.
    """

    def __init__(self, cfg: ModelConfig, pilots: Optional[List[Pilot]] = None,
                 *, global_batch: int = 8, seq: int = 64,
                 hyper: adamw.Hyper = adamw.Hyper(lr=1e-3),
                 compress: bool = True, seed: int = 0,
                 session=None, dataplane: Optional[DataPlane] = None):
        if pilots is None:
            if session is None:
                raise ValueError("need pilots or a session to draw them from")
            pilots = session.pilots_by_runtime("hpc")
        if not pilots:
            raise ValueError("no HPC-runtime pilots available")
        assert global_batch % len(pilots) == 0
        self.cfg = cfg
        self.pilots = pilots
        self.dataplane = dataplane or (session.dataplane if session else None)
        self.global_batch = global_batch
        self.seq = seq
        self.hyper = hyper
        self.compress = compress
        self.seed = seed
        self.device = torch.device(pilots[0].devices[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = transformer.init_params(cfg, gen, device=self.device)
        self.opt = adamw.init(self.params)
        self.step_count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self._residuals = (compression.init_residuals(self.params)
                           if compress else None)
        self.pipeline = TokenPipeline(cfg, batch=global_batch, seq=seq,
                                      seed=seed, device=self.device)
        self.wire_bytes = 0      # inter-pilot gradient traffic (post-compression)
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------- rounds
    def _grad_cu(self, pilot: Pilot, params, shard: Dict[str, Any]):
        cfg = self.cfg
        home = self.device

        def job(mesh=None):
            dev = torch.device(pilot.devices[0])
            p = tree_map(lambda t: t.to(dev), params)
            mb = {k: v.to(dev) for k, v in shard.items()}
            loss, grads = value_and_grad(
                lambda q: transformer.loss_fn(cfg, q, mb, remat=False), p)
            return float(loss), tree_map(lambda g: g.to(home), grads)

        return pilot.submit(ComputeUnitDescription(
            fn=job, gang=True, n_chips=len(pilot.devices), tag="dp-grad"))

    def _exchange(self, grad_list: List[Any]) -> Any:
        """Average gradients across pilots over the 'slow' link.

        Plain mode ships f32; compressed mode ships int8 + one scale per
        leaf (error feedback keeps the running sum exact in expectation).
        """
        n = len(grad_list)
        if not self.compress:
            for g in grad_list:
                self.wire_bytes += sum(x.numel() * x.element_size()
                                       for x in tree_leaves(g))
            return tree_map(lambda *gs: sum(gs) / n, *grad_list)

        new_residuals = []

        def combine(res, *gs):
            total = sum(g.float() for g in gs) / n
            q, scale, new_res = compression.ef_quantize(total, res)
            self.wire_bytes += q.numel() * q.element_size() + 4
            new_residuals.append(new_res)
            return compression.dequantize_int8(q, scale)

        avg = tree_map(combine, self._residuals, *grad_list)
        it = iter(new_residuals)      # tree_map's order, both times
        self._residuals = tree_map(lambda _: next(it), self._residuals)
        return avg

    def run(self, n_rounds: int, *, log_every: int = 5) -> List[Dict[str, float]]:
        per = self.global_batch // len(self.pilots)
        for rnd in range(n_rounds):
            batch = self.pipeline.batch_at(rnd)
            shards = [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                      for i in range(len(self.pilots))]
            cus = [self._grad_cu(p, self.params, s)
                   for p, s in zip(self.pilots, shards)]
            results = [cu.wait(600) for cu in cus]
            losses = [r[0] for r in results]
            wire_before = self.wire_bytes
            avg_grads = self._exchange([r[1] for r in results])
            if self.dataplane is not None:
                self.dataplane.record_moved(self.wire_bytes - wire_before,
                                            Link.DCN, "grad-exchange")
            self.params, self.opt, om = adamw.update(
                self.params, avg_grads, self.opt, self.step_count, self.hyper)
            self.step_count = self.step_count + 1
            rec = {"round": rnd, "loss": float(np.mean(losses)),
                   "grad_norm": float(om["grad_norm"]),
                   "wire_mb": self.wire_bytes / 1e6}
            self.history.append(rec)
            if log_every and rnd % log_every == 0:
                print(f"round {rnd:3d} loss {rec['loss']:.4f} "
                      f"wire {rec['wire_mb']:.2f} MB")
        return self.history
