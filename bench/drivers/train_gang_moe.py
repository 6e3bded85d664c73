"""Training a mixture-of-experts model as a gang CU on a pilot: the
program's ``Trainer`` on its own token pipeline, one process, one card,
held against the plain DeepSeek-V2 reference (``reference/deepseek_v2``).

The same run as ``train_gang`` (its config-free pieces are taken from
there: the optimizer's settings, the feed that stops at the deadline,
the window, the gaps and the release of the program's state), with this
model's weights and reference, and the program's MoE counters: reset
when the window starts and read once after it
(``models.layers.moe.counters``), into ``run.records["moe"]`` (calls,
rows and the most-loaded held expert's rows over the mean, per call).
A program whose ``ModelConfig`` lacks this model's settings fails at
once (``NEEDS``).

Traffic (``workloads/<cell>.json``): as ``train_gang``'s.  ``control``
takes ``fp8`` (the reference in float8, the step below bf16) and the
planted faults ``renorm`` (the top-k probabilities renormalised),
``no_mscale`` (YaRN's softmax factor left out) and ``drop_expert`` (held
expert 0's rows dropped), each the reference in the program's place.
"""
from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict

import torch

from lib import harness, seeds
from lib.model import model_config
from reference import deepseek_v2

base = harness.load_module(Path(__file__).with_name("train_gang.py"),
                           "bench_driver_train_gang_base")
hyper, gaps, release, TIMEOUT_S = (base.hyper, base.gaps, base.release,
                                   base.TIMEOUT_S)


def _named(tree) -> Dict[str, torch.Tensor]:
    return {deepseek_v2.path_name(p): base._local(t)
            for p, t in deepseek_v2.leaves(tree)}


# the program's settings of the MoE layer and of YaRN this driver runs
NEEDS = ("moe_experts_held", "moe_drop_free", "moe_norm_topk",
         "moe_seq_aux", "moe_aux_alpha", "rope_yarn")


def _check_program(config) -> None:
    """Fail at once where the program's ``ModelConfig`` lacks one of
    ``NEEDS`` that the configuration sets: it would run another model."""
    import dataclasses
    from repro_torch.models.config import ModelConfig
    have = {f.name for f in dataclasses.fields(ModelConfig)}
    missing = sorted(k for k in NEEDS if k in config and k not in have)
    if missing:
        raise RuntimeError("the program cannot run this configuration: its "
                           f"ModelConfig has no {missing}")


def setup(run) -> None:
    t0 = time.monotonic()
    _check_program(run.config)
    from repro_torch.core import (ComputeUnitDescription, PilotDescription,
                                  PilotManager, ResourceManager)
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_state
    from repro_torch.train.trainer import Trainer
    run.part("imports", t0)
    cfg, tr, dev = model_config(run.config), run.traffic, run.device
    t0 = time.monotonic()
    pm = PilotManager(ResourceManager(devices=[dev]))
    pilot = pm.submit(PilotDescription(n_chips=1, name=run.cell.name))
    run.part("pilot", t0)

    t0 = time.monotonic()
    wseed = seeds.derive(run.seed, "weights")
    held = {"params": deepseek_v2.init_params(run.config, wseed, dev)}
    run.sync()
    run.part("weights", t0)
    h = hyper(run)
    data_seed = seeds.derive(run.seed, "data")
    n_check = int(tr["check_steps"])
    got: Dict[str, Any] = {}

    def job(mesh=None):
        trainer = Trainer(cfg, mesh, global_batch=tr["batch"], seq=tr["seq"],
                          hyper=adamw.Hyper(lr=h["lr"]),
                          n_microbatches=tr["microbatches"], seed=data_seed,
                          warmup_steps=h["warmup_steps"],
                          total_steps=h["total_steps"])
        trainer.state = make_train_state(cfg, held.pop("params"))
        t = time.monotonic()
        trainer.run(1, log_every=0)
        run.sync()
        run.part("first_step", t)
        got["first_grad"] = {
            k: float(m.float().norm()) / (1.0 - h["b1"])
            for k, m in _named(trainer.state["opt"]["m"]).items()}
        t = time.monotonic()
        trainer.run(n_check, log_every=0)
        run.sync()
        run.part("checked_steps", t)
        got["losses"] = [s["loss"] for s in trainer.history[:n_check]]
        t = time.monotonic()
        start = _named(deepseek_v2.init_params(run.config, wseed, dev))
        got["change"] = {
            k: float((p.float() - start[k].float()).norm())
            for k, p in _named(trainer.state["params"]).items()}
        del start
        run.part("check_snapshot", t)
        return trainer

    cu = pilot.submit(ComputeUnitDescription(fn=job, n_chips=1, gang=True,
                                             tag="train"))
    trainer = cu.wait(TIMEOUT_S)
    run.records.update(pm=pm, pilot=pilot, trainer=trainer, program=got,
                       data_seed=data_seed, steps=[], moe=None,
                       microbatch=(tr["batch"] // tr["microbatches"],
                                   tr["seq"]))
    run.notes["setup_cu_overhead_s"] = cu.overhead_s()


def window(run, deadline: float) -> None:
    from repro_torch.models.layers import moe
    moe.reset_counters()
    base.window(run, deadline)
    c = moe.counters()
    if c and c["calls"]:
        run.records["moe"] = {"calls": c["calls"],
                              "rows_per_call": c["rows"] / c["calls"],
                              "imbalance": c["imbalance"] / c["calls"]}
        print(f"moe counters: {run.records['moe']}", file=sys.stderr,
              flush=True)


def reference(run, fault=None) -> Dict[str, Any]:
    """The reference's checked steps from the seed's weights and batches;
    `fault` one of ``deepseek_v2.FAULTS`` (the control and the planted
    faults) or None."""
    from reference import train_deepseek as ref_train
    tr = run.traffic
    params = deepseek_v2.init_params(run.config,
                                     seeds.derive(run.seed, "weights"),
                                     run.device)
    batches = [ref_train.batch_at(run.config, run.records["data_seed"], s,
                                  tr["batch"], tr["seq"])
               for s in range(int(tr["check_steps"]))]
    out = ref_train.steps(run.config, params, batches, hyper(run),
                          rows=int(tr["rows"]), fault=fault)
    del params
    return out


def check(run):
    got = run.records["program"]
    release(run)
    t0 = time.monotonic()
    ref = reference(run)
    print(f"reference: {time.monotonic() - t0:.1f} s, losses {ref['losses']}"
          f" (program {got['losses']})", file=sys.stderr, flush=True)
    run.notes["reference"] = ref
    med = statistics.median(ref["first_grad"].values())
    run.notes["left_out_of_change"] = sorted(
        k for k, g in ref["first_grad"].items() if g < 1e-3 * med)
    lim = run.traffic["limits"]
    return [(k, v, lim[k]) for k, v in gaps(got, ref).items()]


def control(run, kind: str = "fp8") -> Dict[str, float]:
    """The compared numbers with the reference, computed with `kind`
    (``deepseek_v2.FAULTS``), in the program's place."""
    if kind not in deepseek_v2.FAULTS:
        raise ValueError(f"control: {kind!r} not in {deepseek_v2.FAULTS}")
    return gaps(reference(run, fault=kind), run.notes["reference"])
