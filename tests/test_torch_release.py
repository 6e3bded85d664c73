"""A finished trainer's state is freed by reference counting alone.

A train state on the card is tens of GB, so it must go when its last
user drops it, not when the cycle collector next runs.  Each case runs
with ``gc`` disabled, keeps a ``weakref`` to a parameter leaf (the
local tensor of its DTensor) of a trainer that has run one step, drops
every reference the caller holds and checks that the leaf is gone:

* a ``Trainer`` on a one-device grid, called directly;
* the trainer of ``examples/torch_hybrid_pipeline.py``'s DAG (one
  round, one step, on a Session over ``[cpu] * 2``) after
  ``Session.shutdown``.  Before the repair the agent kept every finished
  CU and its executor cache, whose job closures hold the Session, whose
  pilots hold the agent: a cycle that kept the trainer's state alive.
"""
import gc
import importlib.util
import pathlib
import weakref

import torch

from repro_torch import configs
from repro_torch.core import DeviceGrid
from repro_torch.sharding import parallel
from repro_torch.train.trainer import Trainer
from repro_torch.util import tree_leaves

CPU = torch.device("cpu")
ARCH = "hymba-1.5b"


def _leaf_ref(trainer) -> weakref.ref:
    leaf = parallel.local(tree_leaves(trainer.state["params"])[0])
    return weakref.ref(leaf)


def _no_gc(fn):
    """fn() with the cycle collector off; returns its result."""
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        return fn()
    finally:
        if was:
            gc.enable()


def test_trainer_state_is_freed_without_gc():
    def run():
        tr = Trainer(configs.get_smoke(ARCH), DeviceGrid([CPU]),
                     global_batch=2, seq=16)
        tr.run(1, log_every=0)
        ref, tref = _leaf_ref(tr), weakref.ref(tr)
        del tr
        return ref() is None and tref() is None
    assert _no_gc(run)


def _example():
    path = pathlib.Path(__file__).parent.parent / "examples" / \
        "torch_hybrid_pipeline.py"
    spec = importlib.util.spec_from_file_location("torch_hybrid_pipeline",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hybrid_pipeline_trainer_is_freed_after_shutdown_without_gc(
        monkeypatch):
    example = _example()
    refs = []

    class Recorded(Trainer):
        def run(self, *args, **kwargs):
            out = super().run(*args, **kwargs)
            refs.append(_leaf_ref(self))
            return out

    monkeypatch.setattr(example, "Trainer", Recorded)

    def run():
        session = example.make_session(CPU)
        try:
            example.run_pipeline(session, configs.get_smoke(ARCH), rounds=1,
                                 batch=2, seq=16, steps_per_round=1)
        finally:
            session.shutdown()
        del session
        return len(refs) == 1 and refs[0]() is None
    assert _no_gc(run)
