"""Cross-pilot data parallelism on the port, against the JAX reference.

The four cases of ``tests/test_multi_pilot.py`` on port pilots over
``[cpu] * 2``, the Session case of ``tests/test_session.py``
(``test_multi_pilot_trainer_reports_wire_bytes_to_dataplane``), and both
packages' trainers from the reference's init on the same config:
``wire_bytes`` and the DCN ledger equal byte for byte, plain and
compressed, and the round losses and grad norms at rtol 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import PilotDescription as JPilotDescription
from repro.core import ResourceManager as JResourceManager
from repro.core import Session as JSession
from repro.train.multi_pilot import MultiPilotTrainer as JMultiPilotTrainer

from repro_torch import configs
from repro_torch.core import (Link, Pilot, PilotDescription, PilotManager,
                              ResourceManager, Session)
from repro_torch.convert import params_from_numpy
from repro_torch.optim import adamw, compression
from repro_torch.train.multi_pilot import MultiPilotTrainer

CPU = torch.device("cpu")


@pytest.fixture
def two_pilots():
    # two logical slots on the one real device: separate allocations
    pm = PilotManager(ResourceManager(devices=[CPU] * 2))
    p1 = pm.submit(PilotDescription(n_chips=1, name="pod-a"))
    p2 = pm.submit(PilotDescription(n_chips=1, name="pod-b"))
    yield [p1, p2]
    pm.shutdown()


def test_multi_pilot_dp_learns(two_pilots):
    cfg = configs.get_smoke("llama3.2-1b")
    tr = MultiPilotTrainer(cfg, two_pilots, global_batch=8, seq=32,
                           hyper=adamw.Hyper(lr=1e-2), compress=True, seed=0)
    hist = tr.run(20, log_every=0)
    first = np.mean([h["loss"] for h in hist[:4]])
    last = np.mean([h["loss"] for h in hist[-4:]])
    assert last < first - 0.3, f"no learning: {first:.3f} -> {last:.3f}"
    assert tr.wire_bytes > 0


def test_compression_quarters_wire_bytes(two_pilots):
    cfg = configs.get_smoke("internlm2-1.8b")
    t_plain = MultiPilotTrainer(cfg, two_pilots, global_batch=4, seq=16,
                                compress=False, seed=1)
    t_plain.run(2, log_every=0)
    t_comp = MultiPilotTrainer(cfg, two_pilots, global_batch=4, seq=16,
                               compress=True, seed=1)
    t_comp.run(2, log_every=0)
    ratio = t_plain.wire_bytes / t_comp.wire_bytes
    assert ratio > 3.5, f"compression ratio only {ratio:.2f}x"


def test_compressed_matches_plain_convergence(two_pilots):
    """EF-int8 exchange tracks the exact exchange closely over a run."""
    cfg = configs.get_smoke("yi-6b")
    losses = {}
    for compress in (False, True):
        tr = MultiPilotTrainer(cfg, two_pilots, global_batch=4, seq=16,
                               hyper=adamw.Hyper(lr=3e-3), compress=compress,
                               seed=2)
        losses[compress] = [h["loss"] for h in tr.run(10, log_every=0)]
    final_gap = abs(losses[True][-1] - losses[False][-1])
    assert final_gap < 0.15, (losses[False][-1], losses[True][-1])


def test_elastic_pilot_join(two_pilots):
    """A third pilot can join between rounds (batch re-split)."""
    cfg = configs.get_smoke("llama3.2-1b")
    rm = two_pilots[0].rm
    tr = MultiPilotTrainer(cfg, two_pilots, global_batch=8, seq=16, seed=3)
    tr.run(2, log_every=0)
    rm._devices.append(CPU)                # capacity arrives
    p3 = Pilot(PilotDescription(n_chips=1, name="pod-c"), rm).start()
    tr.pilots.append(p3)
    assert tr.global_batch % len(tr.pilots) != 0  # 8 % 3 != 0 -> resize
    tr.global_batch = 9
    tr.pipeline.batch = 9
    hist = tr.run(4, log_every=0)
    assert len(hist) == 2 + 4
    p3.shutdown()


def test_multi_pilot_trainer_reports_wire_bytes_to_dataplane():
    """The trainer is a Session client: gradient-exchange traffic lands
    on the shared DCN ledger."""
    s = Session(ResourceManager(devices=[CPU] * 2))
    s.add_pilot(PilotDescription(n_chips=1, name="pod-a", runtime="hpc"))
    s.add_pilot(PilotDescription(n_chips=1, name="pod-b", runtime="hpc"))
    try:
        cfg = configs.get_smoke("llama3.2-1b")
        tr = MultiPilotTrainer(cfg, global_batch=4, seq=16, session=s, seed=0)
        assert tr.pilots == s.pilots_by_runtime("hpc")
        tr.run(2, log_every=0)
        assert tr.wire_bytes > 0
        assert s.dataplane.moved_by_link(Link.DCN) == tr.wire_bytes
        assert s.dataplane.ledger()["by_reason"]["grad-exchange"] \
            == tr.wire_bytes
    finally:
        s.shutdown()


def test_no_pilots_raises():
    cfg = configs.get_smoke("llama3.2-1b")
    with pytest.raises(ValueError, match="need pilots"):
        MultiPilotTrainer(cfg)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_wire_bytes_and_ledger_equal_reference(compress):
    """Both packages' trainers, each on a Session of two HPC pilots, 2
    rounds: the same wire bytes, history wire MB and DCN ledger.  (The
    reference's gradient CUs run JAX op by op, ~25 s a round at Hymba's
    smoke config, so one arch.)"""
    arch = "llama3.2-1b"
    kw = dict(global_batch=4, seq=16, seed=0, compress=compress)
    js = JSession(JResourceManager(devices=jax.devices() * 2))
    ts = Session(ResourceManager(devices=[CPU] * 2))
    for s, desc in ((js, JPilotDescription), (ts, PilotDescription)):
        s.add_pilot(desc(n_chips=1, name="pod-a", runtime="hpc"))
        s.add_pilot(desc(n_chips=1, name="pod-b", runtime="hpc"))
    try:
        jt = JMultiPilotTrainer(jconfigs.get_smoke(arch), session=js, **kw)
        tt = MultiPilotTrainer(configs.get_smoke(arch), session=ts, **kw)
        # the reference's init, so that the losses compare too
        tt.params = params_from_numpy(jax.tree.map(np.array, jt.params), CPU)
        tt.opt = adamw.init(tt.params)
        if compress:
            tt._residuals = compression.init_residuals(tt.params)
        jh, th = jt.run(2, log_every=0), tt.run(2, log_every=0)
        assert tt.wire_bytes == jt.wire_bytes > 0
        assert [h["wire_mb"] for h in th] == [h["wire_mb"] for h in jh]
        assert ts.dataplane.ledger() == js.dataplane.ledger()
        assert ts.dataplane.moved_by_link(Link.DCN) == tt.wire_bytes
    finally:
        js.shutdown()
        ts.shutdown()
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in th], [h[key] for h in jh],
                                   rtol=1e-4, err_msg=key)
