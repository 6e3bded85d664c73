"""Training as a gang CU on a pilot: the program's ``Trainer`` on its own
token pipeline, one process, one card.

Configuration (``configs/<config>.json``): the model's sizes, as the
program's ``ModelConfig`` fields.  Traffic (``workloads/<cell>.json``):
``batch`` rows of ``seq`` tokens in ``microbatches``, the optimizer
(``lr``, ``warmup_steps``, ``total_steps``), ``check_steps`` (the first
steps, run in set-up, that the reference follows) and ``rows``, the rows
the reference takes at a time.

Set-up draws the weights on the card from the seed, builds one Trainer
in a CU, and drives it through the first ``check_steps`` steps; the
window hands that same Trainer to a second CU, whose one ``run`` call
takes steps until the window's time is spent (the pipeline stops giving
batches at the deadline, so every step runs whole).
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Any, Dict, List

import torch

from lib import seeds
from lib.model import model_config
from reference import hymba

TIMEOUT_S = 1800.0


def hyper(run) -> Dict[str, float]:
    tr = run.traffic
    return {"lr": tr["lr"], "b1": 0.9, "b2": 0.95, "eps": 1e-8,
            "weight_decay": 0.1, "clip_norm": 1.0,
            "warmup_steps": tr["warmup_steps"],
            "total_steps": tr["total_steps"]}


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _named(tree) -> Dict[str, torch.Tensor]:
    return {hymba.path_name(p): _local(t) for p, t in hymba.leaves(tree)}


class Feed:
    """The trainer's pipeline, stopping at `deadline`: ``next`` raises
    StopIteration from then on, so the trainer's loop ends after the step
    in flight.  Each call's time is kept: the last one marks the end of
    the last step."""

    def __init__(self, pipeline, deadline: float):
        self.pipeline = pipeline
        self.deadline = deadline
        self.calls: List[float] = []

    def start(self, from_step: int = 0):
        self.pipeline.start(from_step)
        return self

    def stop(self):
        self.pipeline.stop()

    def __iter__(self):
        return self

    def __next__(self):
        now = time.monotonic()
        self.calls.append(now)
        if now >= self.deadline:
            raise StopIteration
        return next(self.pipeline)


def setup(run) -> None:
    t0 = time.monotonic()
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
    # held in a dict the CU empties, so that no closure keeps the weights
    held = {"params": hymba.init_params(run.config, wseed, dev)}
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
        # the first gradient as the optimizer got it: m = (1 - b1) g
        got["first_grad"] = {
            k: float(m.float().norm()) / (1.0 - h["b1"])
            for k, m in _named(trainer.state["opt"]["m"]).items()}
        t = time.monotonic()
        trainer.run(n_check, log_every=0)
        run.sync()
        run.part("checked_steps", t)
        got["losses"] = [s["loss"] for s in trainer.history[:n_check]]
        t = time.monotonic()
        start = _named(hymba.init_params(run.config, wseed, dev))
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
                       data_seed=data_seed, steps=[],
                       microbatch=(tr["batch"] // tr["microbatches"],
                                   tr["seq"]))
    run.notes["setup_cu_overhead_s"] = cu.overhead_s()


def window(run, deadline: float) -> None:
    from repro_torch.core import ComputeUnitDescription
    tr = run.traffic
    trainer = run.records["trainer"]
    feed = Feed(trainer.pipeline, deadline)
    done = len(trainer.history)

    def job(mesh=None):
        trainer.pipeline = feed
        try:
            with run.spans.span("bench.train_window"):
                trainer.run(10 ** 9, log_every=0)
        finally:
            trainer.pipeline = feed.pipeline

    cu = run.records["pilot"].submit(ComputeUnitDescription(
        fn=job, n_chips=1, gang=True, tag="train"))
    try:
        cu.wait(TIMEOUT_S)
    except Exception:
        run.failed += 1
        raise
    steps = trainer.history[done:]
    tokens = tr["batch"] * tr["seq"]
    # a step ends where the trainer asks for the next batch
    run.records["steps"] = [{"t0": a, "t1": b, "tokens": tokens,
                             "loss": s["loss"]}
                            for s, a, b in zip(steps, feed.calls,
                                               feed.calls[1:])]
    run.attempted = len(steps)
    run.window_end = feed.calls[-1]


def release(run) -> None:
    """Free the program's state before the reference runs."""
    run.records.pop("trainer", None)
    pm = run.records.pop("pm", None)
    if pm is not None:
        pm.shutdown()
    run.records.pop("pilot", None)
    import gc
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()


def reference(run, quant=None, rows_kept=None) -> Dict[str, Any]:
    """The reference's checked steps from the seed's weights and batches;
    `quant` and `rows_kept` (the first rows of each batch only) give the
    control and the half-batch fault in the program's place."""
    from reference import train as ref_train
    tr = run.traffic
    params = hymba.init_params(run.config, seeds.derive(run.seed, "weights"),
                               run.device)
    batches = [ref_train.batch_at(run.config, run.records["data_seed"], s,
                                  tr["batch"], tr["seq"])
               for s in range(int(tr["check_steps"]))]
    if rows_kept is not None:
        batches = [{k: v[:rows_kept] for k, v in b.items()} for b in batches]
    out = ref_train.steps(run.config, params, batches, hyper(run),
                          rows=int(tr["rows"]), quant=quant)
    del params
    return out


def gaps(got: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The numbers compared: the largest relative gap of a step's loss,
    and by the worst leaf the gap between the program's and the
    reference's norms of the first gradient and of the change over the
    checked steps, over the larger of the reference leaf's norm and the
    median leaf's.  A leaf whose reference gradient is under a thousandth
    of the median leaf's moves by round-off alone and is left out of the
    change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  ref["losses"]))
    g_ref = ref["first_grad"]
    med_g = statistics.median(g_ref.values())
    grad = max(abs(got["first_grad"][k] - g) / max(g, med_g)
               for k, g in g_ref.items())
    moved = {k: c for k, c in ref["change"].items()
             if g_ref[k] >= 1e-3 * med_g}
    med_c = statistics.median(moved.values())
    change = max(abs(got["change"][k] - c) / max(c, med_c)
                 for k, c in moved.items())
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


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
    """The compared numbers with the reference in the program's place,
    computed in float8 (``fp8``, the step below bf16) or on the first
    half of each batch's rows (``half``, a planted fault)."""
    tr = run.traffic
    cand = (reference(run, quant="fp8") if kind == "fp8" else
            reference(run, rows_kept=tr["batch"] // 2))
    return gaps(cand, run.notes["reference"])
