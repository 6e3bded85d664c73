"""The port's training path against the JAX reference, on the CPU.

* ``TokenPipeline.batch_at`` gives the reference's batches array for
  array (both distributions; the vision and enc-dec extras).
* The reference ``Trainer`` (on a ``compat.make_mesh`` mesh) and the
  port's (on a ``DeviceGrid`` of the CPU), from the same converted
  state, 5 steps: loss and ``grad_norm`` per step at rtol 1e-4, final
  params at 1e-3.
* ``n_microbatches`` 1 vs 4 inside the port (the reference's
  ``test_train_microbatched_matches_flat_loss``, rel 2e-2).
* The four training cases of ``tests/test_system.py`` on the port.
* A checkpoint written by either package restores in the other and
  continues with the writer's losses.
* ``python -m repro_torch.launch.train --device cpu`` runs to its end.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import compat
from repro import configs as jconfigs
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs as tconfigs
from repro_torch.analytics import kmeans as tkm
from repro_torch.convert import (to_numpy, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.core import (ComputeUnitDescription, DeviceGrid,
                              PilotDescription, PilotManager, ResourceManager)
from repro_torch.data.pipeline import TokenPipeline as TPipeline
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw as tadamw
from repro_torch.train.step import abstract_train_state
from repro_torch.train.trainer import Trainer as TTrainer
from repro_torch.util import tree_paths

CPU = torch.device("cpu")


def _jmesh():
    return compat.make_mesh((1, 1), ("data", "model"))


def _grid():
    return DeviceGrid([CPU])


def _np_state(jtrainer):
    """A host copy of the reference trainer's state (its jitted step
    donates the device buffers)."""
    return jax.tree.map(np.array, jtrainer.state)


# ----------------------------------------------------------- pipeline
@pytest.mark.parametrize("distribution", ["sequence", "uniform"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "internvl2-2b",
                                  "seamless-m4t-medium"])
def test_batch_at_equals_reference(arch, distribution):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    seq = 48 if jcfg.frontend == "vision" else 24
    jp = JPipeline(jcfg, batch=3, seq=seq, seed=7, distribution=distribution)
    tp = TPipeline(tcfg, batch=3, seq=seq, seed=7, device=CPU,
                   distribution=distribution)
    for step in (0, 5):
        want = {k: np.asarray(v) for k, v in jp.batch_at(step).items()}
        got = tp.batch_at(step)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.array_equal(g, w), k


def test_restarted_pipeline_yields_no_stale_batch():
    """stop() then start(from_step) yields from_step first: a batch the
    producer put while stopping is dropped (the reference's stop() can
    leave one in the queue)."""
    cfg = tconfigs.get_smoke("llama3.2-1b")
    tp = TPipeline(cfg, batch=2, seq=8, seed=1, device=CPU)
    for start in (0, 7, 3):
        tp.start(from_step=start)
        try:
            first = next(tp)
        finally:
            tp.stop()
        assert torch.equal(first["tokens"], tp.batch_at(start)["tokens"])
        assert tp._q.empty()


def test_prefetch_stream_is_the_batch_at_stream():
    cfg = tconfigs.get_smoke("llama3.2-1b")
    tp = TPipeline(cfg, batch=2, seq=8, seed=1, device=CPU).start(from_step=3)
    try:
        got = [next(tp) for _ in range(4)]
    finally:
        tp.stop()
    for i, b in enumerate(got):
        assert torch.equal(b["tokens"], tp.batch_at(3 + i)["tokens"])


# ------------------------------------------------------ trainer parity
@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b"])
def test_trainer_matches_reference(arch):
    kw = dict(global_batch=4, seq=32, seed=0, warmup_steps=2, total_steps=10)
    jtr = JTrainer(jconfigs.get_smoke(arch), _jmesh(), **kw)
    jtr.init_state()
    ttr = TTrainer(tconfigs.get_smoke(arch), _grid(), **kw)
    ttr.state = train_state_from_numpy(_np_state(jtr), CPU)
    want = jtr.run(5, log_every=0)
    got = ttr.run(5, log_every=0)
    assert [h["step"] for h in got] == [h["step"] for h in want]
    assert set(got[0]) == set(want[0])
    for key in ("loss", "grad_norm", "lr_scale"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=1e-4,
                                   err_msg=key)
    want_p = dict(tree_paths(jax.tree.map(np.asarray, jtr.state["params"])))
    for path, t in tree_paths(ttr.state["params"]):
        np.testing.assert_allclose(to_numpy(t), want_p[path], rtol=1e-3,
                                   atol=1e-3, err_msg=str(path))
    assert int(ttr.state["step"]) == 5


def test_train_microbatched_matches_flat_loss():
    cfg = tconfigs.get_smoke("internlm2-1.8b")
    t1 = TTrainer(cfg, _grid(), global_batch=8, seq=16, n_microbatches=1,
                  seed=1)
    t2 = TTrainer(cfg, _grid(), global_batch=8, seq=16, n_microbatches=4,
                  seed=1)
    h1 = t1.run(3, log_every=0)
    h2 = t2.run(3, log_every=0)
    gaps = [abs(a["loss"] - b["loss"]) / abs(a["loss"]) for a, b in zip(h1, h2)]
    print(f"microbatches 1 vs 4: rel loss gaps {gaps}")
    assert gaps[0] < 1e-6   # the same params: only the sum's order differs
    for a, b in zip(h1, h2):
        assert a["loss"] == pytest.approx(b["loss"], rel=2e-2)


# ------------------------------------- tests/test_system.py on the port
@pytest.fixture
def pm():
    m = PilotManager(ResourceManager(devices=[CPU]))
    yield m
    m.shutdown()


def test_train_loss_decreases():
    cfg = tconfigs.get_smoke("llama3.2-1b")
    tr = TTrainer(cfg, _grid(), global_batch=8, seq=32,
                  hyper=tadamw.Hyper(lr=1e-2), seed=0)
    hist = tr.run(60, log_every=0)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.5, f"no learning: {first:.3f} -> {last:.3f}"


def test_checkpoint_restart_resumes_exactly(tmp_path):
    cfg = tconfigs.get_smoke("yi-6b")
    d = str(tmp_path / "ck")
    t1 = TTrainer(cfg, _grid(), global_batch=4, seq=16, ckpt_dir=d,
                  ckpt_every=5, seed=2)
    t1.run(10, log_every=0)
    t2 = TTrainer(cfg, _grid(), global_batch=4, seq=16, ckpt_dir=d,
                  ckpt_every=5, seed=2)
    assert t2.restore() == 10
    h2 = t2.run(12, log_every=0)
    assert [h["step"] for h in h2] == [10, 11]
    t3 = TTrainer(cfg, _grid(), global_batch=4, seq=16, seed=2)
    ref = {h["step"]: h["loss"] for h in t3.run(12, log_every=0)}
    for h in h2:
        assert h["loss"] == pytest.approx(ref[h["step"]], rel=1e-3)


def test_failure_recovery_via_checkpoint(tmp_path):
    cfg = tconfigs.get_smoke("llama3.2-1b")
    d = str(tmp_path / "ck")
    tr = TTrainer(cfg, _grid(), global_batch=4, seq=16, ckpt_dir=d,
                  ckpt_every=4, seed=3)
    with pytest.raises(RuntimeError, match="injected node failure"):
        tr.run(20, log_every=0, inject_failure_at=9)
    tr2 = TTrainer(cfg, _grid(), global_batch=4, seq=16, ckpt_dir=d, seed=3)
    assert tr2.restore() == 8   # last checkpoint before the failure
    hist = tr2.run(12, log_every=0)
    assert hist[-1]["step"] == 11


def test_coupled_hpc_analytics_pipeline(pm):
    """Training produces trajectory data in a gang CU; a Mode-I analytics
    cluster clusters it with K-Means; all on one pilot."""
    from repro_torch.data.batches import make_batch
    from repro_torch.models import transformer
    pilot = pm.submit(PilotDescription(n_chips=1, name="coupled"))
    cfg = tconfigs.get_smoke("hymba-1.5b")

    def hpc_stage(mesh=None):
        tr = TTrainer(cfg, mesh, global_batch=4, seq=16, seed=4)
        hist = tr.run(3, log_every=0)
        b = make_batch(cfg, "train", 4, 16, np.random.default_rng(0),
                       device=CPU)
        with torch.no_grad():
            logits, _ = transformer.forward(cfg, tr.state["params"], b,
                                            remat=False)
        return hist[-1]["loss"], logits.reshape(-1, logits.shape[-1])[:, :3]

    cu = pilot.submit(ComputeUnitDescription(fn=hpc_stage, gang=True,
                                             n_chips=1, tag="sim"))
    loss, traj = cu.wait(600)
    assert np.isfinite(loss)
    cluster = pilot.spawn_analytics_cluster(1)
    cluster.engine.put("traj", traj.contiguous())
    centroids, cost = tkm.kmeans_fit(cluster.engine, "traj", 4, iters=2)
    assert np.isfinite(cost) and tuple(centroids.shape) == (4, 3)
    cluster.shutdown()
    assert pilot.agent.scheduler.n_free == 1  # chips returned to HPC stage


def test_more_than_one_device_raises():
    """A grid of more than one device no longer raises: a
    ``DeviceGrid([CPU, CPU])`` trainer (2 gloo ranks, batch over "data")
    runs, its losses and grad norms equal one device's to rel 1e-5, and a
    second run goes on from the state it handed back.  (The name is
    historical: it is kept so that the test's ID stays the same since
    the refusal it once asserted was removed.)"""
    cfg = tconfigs.get_smoke("llama3.2-1b")
    kw = dict(global_batch=4, seq=16, seed=3)
    one = TTrainer(cfg, _grid(), **kw)
    two = TTrainer(cfg, DeviceGrid([CPU, CPU]), **kw)
    want = one.run(3, log_every=0)
    assert [h["step"] for h in two.run(2, log_every=0)] == [0, 1]
    assert int(two.state["step"]) == 2
    got = two.run(3, log_every=0)
    assert [h["step"] for h in got] == [0, 1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-5)


# ------------------------------------------- checkpoints across packages
def _manifest(d, step):
    with open(f"{d}/step-{step:08d}/manifest.json") as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    arch = "llama3.2-1b"
    kw = dict(global_batch=4, seq=16, seed=5, ckpt_every=2)
    jtr = JTrainer(jconfigs.get_smoke(arch), _jmesh(),
                   ckpt_dir=str(tmp_path / "j"), **kw)
    jtr.init_state()
    ttr = TTrainer(tconfigs.get_smoke(arch), _grid(),
                   ckpt_dir=str(tmp_path / "t"), **kw)
    ttr.state = train_state_from_numpy(_np_state(jtr), CPU)
    # one run of 6 steps with a checkpoint every 2; the reader restores
    # step 4 and runs steps 4 and 5.  (Two run() calls on one reference
    # trainer can hand the second a stale prefetched batch: ROADMAP Queue
    # 3, the reference's TokenPipeline.stop.)
    if writer == "reference":
        want = jtr.run(6, log_every=0)[-2:]
        reader = TTrainer(tconfigs.get_smoke(arch), _grid(),
                          ckpt_dir=str(tmp_path / "j"), **kw)
        assert reader.restore() == 6
        reader.state = reader.ckpt.restore(
            abstract_train_state(reader.cfg), step=4, device=CPU)
    else:
        want = ttr.run(6, log_every=0)[-2:]
        reader = JTrainer(jconfigs.get_smoke(arch), _jmesh(),
                          ckpt_dir=str(tmp_path / "t"), **kw)
        assert reader.restore() == 6
        target = jax.eval_shape(lambda: reader.state)
        reader.state = reader.ckpt.restore(
            target, step=4, shardings=reader.state_shardings)
    assert int(np.asarray(reader.state["step"])) == 4
    got = reader.run(6, log_every=0)
    assert [h["step"] for h in got] == [4, 5]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-4)


def test_checkpoint_layout_equals_reference(tmp_path):
    """The same state saved by both packages: the same manifest (keys,
    shapes, raw dtypes) and the same arrays, key for key."""
    from repro.checkpoint import CheckpointManager as JCkpt
    from repro_torch.checkpoint import CheckpointManager as TCkpt
    cfg = jconfigs.get_smoke("hymba-1.5b")
    jtr = JTrainer(cfg, _jmesh(), global_batch=2, seq=8, seed=6)
    jtr.init_state()
    state = _np_state(jtr)
    state["params"]["embed"] = state["params"]["embed"].astype(
        jax.numpy.bfloat16)           # a bf16 leaf, stored as raw uint16
    JCkpt(str(tmp_path / "j")).save(state, 3, blocking=True)
    TCkpt(str(tmp_path / "t")).save(train_state_from_numpy(state, CPU), 3,
                                    blocking=True)
    assert _manifest(tmp_path / "j", 3) == _manifest(tmp_path / "t", 3)
    with np.load(tmp_path / "j/step-00000003/leaves.npz") as a, \
            np.load(tmp_path / "t/step-00000003/leaves.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    back = TCkpt(str(tmp_path / "j")).restore(
        train_state_from_numpy(state, CPU), device=CPU)
    for (p, x), (_, y) in zip(tree_paths(back),
                              tree_paths(train_state_to_numpy(
                                  train_state_from_numpy(state, CPU)))):
        assert np.array_equal(np.atleast_1d(to_numpy(x)).view(np.uint8),
                              np.atleast_1d(y).view(np.uint8)), p


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """An in-place update of CPU tensors after a non-blocking ``save``
    returns (as the port's AdamW makes) does not reach the checkpoint:
    the writer thread is held until the state has been changed."""
    from repro_torch.checkpoint import manager as tmanager
    gen = torch.Generator().manual_seed(3)
    state = {"params": {"w": torch.randn(64, 32, generator=gen),
                        "e": torch.randn(16, 8, generator=gen).bfloat16()},
             "step": torch.tensor(2, dtype=torch.int32)}
    want = {k: v.clone() for k, v in state["params"].items()}
    go, real = __import__("threading").Event(), np.savez

    def held_savez(*args, **kw):
        assert go.wait(30)
        return real(*args, **kw)

    monkeypatch.setattr(tmanager.np, "savez", held_savez)
    ckpt = tmanager.CheckpointManager(str(tmp_path))
    ckpt.save(state, 2, blocking=False)
    for leaf in state["params"].values():
        leaf.add_(1.0)
    go.set()
    ckpt.wait()
    back = ckpt.restore(state, device=CPU)
    for k, w in want.items():
        assert back["params"][k].dtype == w.dtype
        assert torch.equal(back["params"][k], w), k
    assert int(back["step"]) == 2


def test_restore_defaults_to_the_card(tmp_path):
    """``restore`` places leaves on the card unless the caller asks for
    the CPU: without CUDA it raises instead of handing back host
    tensors."""
    from repro_torch.checkpoint import CheckpointManager as TCkpt
    state = {"w": torch.ones(4), "step": torch.tensor(1)}
    ckpt = TCkpt(str(tmp_path))
    ckpt.save(state, 1, blocking=True)
    if torch.cuda.is_available():
        assert ckpt.restore(state)["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.restore(state)
    assert ckpt.restore(state, device=CPU)["w"].device == CPU


def test_launch_train_runs_on_cpu(tmp_path):
    hist = tlaunch.main(["--arch", "hymba-1.5b", "--steps", "3", "--batch",
                         "4", "--seq", "16", "--microbatches", "2",
                         "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
                         "2", "--device", "cpu"])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step-00000002", "step-00000003"]
