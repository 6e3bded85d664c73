"""The port's serving engine, KV pages, router and ``Session.serve_pool``
against the JAX reference.

* Every case of ``tests/test_serving_engine.py`` and the serve cases of
  ``tests/test_fairshare.py``, with the same assertions, on
  ``ModelBackend(device="cpu")`` and ``SimBackend``, with pilots over
  CPU device objects.
* The reference's ``ServeEngine`` and the port's, on the same params and
  prompts (5 requests through 2 slots, so requests join mid-flight),
  give the same tokens per request and the same step, admission and
  token counts (Hymba through K3's plain version on the CPU).
* ``kv_cache_rates`` equals the reference's for every arch's full
  config; a reused slot holds nothing of its previous request; a
  ``ModelBackend`` cannot be pickled, so a Raptor prefill task carries
  no payload; ``serve_pool``'s ledger equals the reference's; and
  ``serve_pool`` over a real model (overlay prefill, pages sized from
  the config) and its recovery from a dead decode pilot give the tokens
  of one engine.
"""
import pickle
import queue as queue_mod
import time

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import ResourceManager as JResourceManager
from repro.core import PilotDescription as JPilotDescription
from repro.core.dataplane import TransferCostModel as JTransferCostModel
from repro.core.session import Session as JSession
from repro.models import transformer as jtransformer
from repro.serve import engine as jengine
from repro.serve import kv_pages as jkv_pages

from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import (ComputeUnitDescription, DataPlane,
                              GFS_ARCHIVE, Link, PilotDescription,
                              PilotManager, QueueConfig, ResourceManager,
                              Session, TransferCostModel)
from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.raptor import MicroTask
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import (KVPageManager, ModelBackend, Request,
                               ServeEngine, SimBackend,
                               StaticBudgetAdmission, kv_cache_rates)

CPU = torch.device("cpu")


def _params(arch, seed=0):
    """(reference cfg, port cfg, reference params, the same as tensors)."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jparams = jtransformer.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, backend=ModelBackend(cfg, params, device="cpu"),
                       **kw)


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
            for n in lengths]


def _serve_alone(cfg, params, prompts, max_new, **kw):
    """Each prompt through its own fresh engine: the reference tokens."""
    outs = []
    for i, p in enumerate(prompts):
        eng = _engine(cfg, params, **kw)
        req = Request(uid=i, tokens=p, max_new=max_new)
        eng.submit(req)
        eng.run_until_drained()
        outs.append(req.output)
    return outs


# ------------------------------------- tests/test_serving_engine.py cases
def test_continuous_batching_serves_all_and_matches_sequential():
    *_, params = _params("llama3.2-1b")
    cfg = tconfigs.get_smoke("llama3.2-1b")
    eng = _engine(cfg, params, slots=2, max_seq=96, prompt_bucket=16)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, (8 + 3 * i,),
                                               dtype=np.int32), max_new=6)
            for i in range(5)]   # 5 requests through 2 slots -> mid-flight joins
    for r in reqs:
        eng.submit(r)
    steps = eng.run_until_drained()
    assert all(r.done for r in reqs)
    assert all(r.output is not None and len(r.output) == 6 for r in reqs)
    assert all((r.output >= 0).all() and (r.output < cfg.vocab_size).all()
               for r in reqs)
    # continuous batching: fewer total decode steps than sequential serving
    assert steps < sum(r.max_new for r in reqs)
    # latency bookkeeping
    assert all(r.t_done >= r.t_first_token >= r.t_submit for r in reqs)


def test_bucketed_prefill_matches_unpadded_bitwise():
    """Left-padding is invisible: a bucket-padded prompt gives the SAME
    tokens as the unpadded run (pad mask + pad-relative RoPE in prefill,
    the per-slot ``start`` in decode)."""
    *_, params = _params("llama3.2-1b")
    cfg = tconfigs.get_smoke("llama3.2-1b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
               for n in (5, 9, 12)]

    def serve(bucket):
        eng = _engine(cfg, params, slots=2, max_seq=64, prompt_bucket=bucket)
        reqs = [Request(uid=i, tokens=p, max_new=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.output for r in reqs]

    padded = serve(16)    # every prompt left-padded up to 16
    exact = serve(1)      # bucket == prompt length: no padding at all
    for a, b in zip(padded, exact):
        assert np.array_equal(a, b), (a, b)


def _two_pilot_plane():
    data = DataPlane(cost_model=TransferCostModel())
    return data, "pilot-a", "pilot-b"


def test_kv_page_transfer_is_ledgered():
    """A cross-pilot splice ships exactly the non-resident page bytes
    over DCN under reason ``kv-splice`` and re-homes the pages; a
    same-pilot splice is the short-circuit read (0 wire bytes)."""
    data, a, b = _two_pilot_plane()
    kv = KVPageManager(data, page_tokens=8, bytes_per_token=100,
                       fixed_bytes=40)
    lease = kv.alloc(7, 20, a)          # 3 pages: 2400 + 40 fixed
    assert lease.nbytes == 3 * 8 * 100 + 40
    assert lease.pages == ["kv/7/p0", "kv/7/p1", "kv/7/p2"]
    assert kv.resident_pilot(7) == a
    wire = kv.splice_to(7, b)
    assert wire == lease.nbytes
    assert kv.resident_pilot(7) == b
    assert data.ledger()["by_reason"]["kv-splice"] == lease.nbytes
    assert data.ledger()["by_link"][Link.DCN] == lease.nbytes
    # decode stays where the cache lives: free splice, nothing ledgered
    assert kv.splice_to(7, b) == 0
    assert kv.stats["local_splices"] == 1
    assert data.ledger()["by_reason"]["kv-splice"] == lease.nbytes
    kv.free(7)
    assert kv.lease(7) is None and lease.pages[0] not in data


def test_kv_spool_restore_round_trip():
    """Cold pages park on the archive tier and promote back intact."""
    data, a, b = _two_pilot_plane()
    kv = KVPageManager(data, page_tokens=4, bytes_per_token=50)
    lease = kv.alloc(3, 8, a)
    spooled = kv.spool(3)
    assert spooled == lease.nbytes and kv.lease(3).spooled
    assert kv.resident_pilot(3) is None          # archive only
    assert GFS_ARCHIVE in data.home_pilots(lease.pages[0])
    assert data.ledger()["by_reason"]["kv-spool"] == lease.nbytes
    restored = kv.restore(3, b)
    assert restored == lease.nbytes and not kv.lease(3).spooled
    assert kv.resident_pilot(3) == b
    assert data.ledger()["by_reason"]["kv-restore"] == lease.nbytes


def _serve_session(dcn=None):
    s = Session(ResourceManager(devices=[CPU] * 6),
                cost_model=TransferCostModel())
    if dcn is not None:
        s.cost_model.dcn_cost_per_byte = dcn
    for name in ("d0", "d1", "pf"):
        s.add_pilot(PilotDescription(n_chips=2, name=name,
                                     enable_speculation=False))
    return s


def _run_pool(sess, router, n=12, max_new=4, tenant="t"):
    reqs = [Request(uid=i, tokens=np.arange(4 + i % 5), max_new=max_new,
                    tenant=tenant) for i in range(n)]
    for r in reqs:
        router.submit(r)
    router.drain(timeout_s=60)
    assert all(r.done and len(r.output) == max_new for r in reqs)
    return reqs


def test_router_prefers_kv_locality_when_dcn_expensive():
    """KV pages home on the prefill pilot; with DCN expensive, dispatch
    lands every decode on that pilot's engine (all local splices) even
    though a second engine sits idle."""
    sess = _serve_session(dcn=1e-3)    # movement >> locality/load
    try:
        router = sess.serve_pool(
            lambda: SimBackend(prefill_s=1e-3, step_s=2e-4),
            slots=2, max_seq=32, prompt_bucket=8,
            decode_pilots=["pf", "d1"], prefill_pilot="pf",
            bytes_per_token=1 << 10)
        _run_pool(sess, router, n=10)
        snap = router.snapshot()
        assert snap["cross_pilot"] == 0
        assert snap["kv"]["local_splices"] == 10
        assert sess.dataplane.ledger()["by_reason"].get("kv-splice", 0) == 0
    finally:
        sess.shutdown()


def test_router_spills_across_pilots_when_dcn_free():
    """With movement ~free and the local engine saturated, the load term
    wins: some decodes ship their KV to the other pilot — and every one
    of those shipments is on the byte ledger."""
    sess = _serve_session(dcn=1e-15)
    try:
        router = sess.serve_pool(
            lambda: SimBackend(prefill_s=5e-4, step_s=2e-3),
            slots=1, max_seq=32, prompt_bucket=8,
            decode_pilots=["pf", "d1"], prefill_pilot="pf",
            bytes_per_token=1 << 10, load_weight=4.0)
        _run_pool(sess, router, n=10, max_new=6)
        snap = router.snapshot()
        assert snap["cross_pilot"] > 0
        assert (sess.dataplane.ledger()["by_reason"]["kv-splice"]
                == snap["splice_bytes"] > 0)
        # both engines actually decoded
        assert all(e["admitted"] > 0 for e in snap["engines"])
    finally:
        sess.shutdown()


def test_drf_budget_binds_across_engines():
    """One QueueTree backs admission for ALL engines: a flooding tenant
    capped at max_chips=2 never holds more than 2 decode slots
    fleet-wide (4 slots exist), while the small tenant drains freely."""
    sess = _serve_session()
    try:
        router = sess.serve_pool(
            lambda: SimBackend(prefill_s=2e-4, step_s=1e-3),
            slots=2, max_seq=32, prompt_bucket=8,
            decode_pilots=["d0", "d1"], prefill_pilot="pf",
            bytes_per_token=1 << 10,
            queue_configs=[QueueConfig("flood", max_chips=2),
                           QueueConfig("small")])
        reqs = [Request(uid=i, tokens=np.arange(5), max_new=5,
                        tenant="flood" if i < 16 else "small")
                for i in range(22)]
        for r in reqs:
            router.submit(r)
        router.drain(timeout_s=60)
        assert all(r.done for r in reqs)
        assert router.admission.peak_slots["flood"] <= 2
        assert router.admission.peak_slots["small"] >= 1
        # a zero budget rejects at intake instead of wedging the drain
        tree = router.admission.tree
        tree.queues["blocked"] = type(tree.queues["flood"])(
            QueueConfig("blocked", max_chips=0))
        with pytest.raises(PermissionError):
            router.submit(Request(uid=99, tokens=np.arange(3),
                                  tenant="blocked"))
    finally:
        sess.shutdown()


def test_serve_backlog_feeds_heartbeat_and_pressure():
    """Engine occupancy rides the agent heartbeat and the ControlPlane
    folds waiting requests into pilot pressure."""
    hb = {"n_slots": 4, "queued_chip_demand": 0, "busy_chips": 0,
          "serve": {"e0": {"waiting": 8}}}
    assert ControlPlane.pressure_of(hb) == pytest.approx(
        ControlPlane.SERVE_BACKLOG_WEIGHT * 8 / 4)
    sess = _serve_session()
    try:
        router = sess.serve_pool(
            lambda: SimBackend(prefill_s=1e-4, step_s=5e-4),
            slots=2, max_seq=32, prompt_bucket=8,
            decode_pilots=["d0"], prefill_pilot="pf",
            bytes_per_token=1 << 10)
        _run_pool(sess, router, n=6)
        st = sess.pilots["d0"].agent.heartbeat()
        (snap,) = st["serve"].values()
        assert snap["admitted"] == 6 and snap["decoded_tokens"] > 0
    finally:
        sess.shutdown()


def test_preemption_evicts_lower_priority():
    """A starved high-priority CU preempts a running low-priority one;
    the victim is re-queued (its .result points at the clone)."""
    pm = PilotManager(ResourceManager(devices=[CPU]))
    try:
        pilot = pm.submit(PilotDescription(n_chips=1))
        order = []

        def slow(name, mesh=None):
            order.append(name)
            time.sleep(0.4)
            return name

        victim = pilot.submit(ComputeUnitDescription(
            fn=slow, args=("victim",), n_chips=1, priority=0, max_retries=1,
            needs_mesh=False))
        time.sleep(0.1)  # let it start
        vip = pilot.submit(ComputeUnitDescription(
            fn=slow, args=("vip",), n_chips=1, priority=10, needs_mesh=False))
        assert vip.wait(30) == "vip"
        stats = pilot.agent.scheduler.stats
        assert stats.get("preempted", 0) >= 1
        # the victim's re-queued clone eventually completes too
        clone = victim.result
        assert clone is not None and clone.wait(30) == "victim"
        assert order.index("vip") < len(order)
    finally:
        pm.shutdown()


def test_heartbeat_status_published():
    pm = PilotManager(ResourceManager(devices=[CPU]))
    try:
        pilot = pm.submit(PilotDescription(n_chips=1))
        pilot.submit(ComputeUnitDescription(
            fn=lambda mesh=None: 1, needs_mesh=False)).wait(30)
        time.sleep(0.4)  # one heartbeat period
        st = pilot.agent.status
        assert st and st["free_chips"] == 1
        assert st["cu_states"].get("done", 0) >= 1
        assert "scheduled" in st["scheduler"]
    finally:
        pm.shutdown()


# ----------------------- tests/test_fairshare.py serve tenant budgets
def _engine_stub(slots=4, tenant_budget=None, default_budget=None):
    """ServeEngine admission state without the model machinery."""
    eng = object.__new__(ServeEngine)
    eng.slots = slots
    eng.admission = StaticBudgetAdmission(tenant_budget, default_budget)
    eng.active = [None] * slots
    return eng


def test_serve_engine_tenant_budget_skips_flooding_tenant():
    toks = np.zeros(4, np.int32)
    a = [Request(uid=i, tokens=toks, tenant="a") for i in range(3)]
    b = Request(uid=9, tokens=toks, tenant="b")
    eng = _engine_stub(tenant_budget={"a": 2})
    waiting = a + [b]
    # a fills up to its budget, then b jumps its third request
    picked = []
    for _ in range(3):
        (req,) = eng.admission.plan(waiting, 1, eng)
        picked.append(req)
        waiting.remove(req)
        eng.active[eng.active.index(None)] = req
    assert picked == [a[0], a[1], b]
    assert eng.admission.plan(waiting, 1, eng) == []   # a's last waits
    eng.active[0] = None                       # one a-slot frees up
    assert eng.admission.plan(waiting, 1, eng) == [a[2]]


def test_serve_engine_no_budget_is_strict_fifo():
    toks = np.zeros(4, np.int32)
    reqs = [Request(uid=i, tokens=toks, tenant="a") for i in range(4)]
    eng = _engine_stub(slots=2)
    assert eng.admission.plan(list(reqs), 2, eng) == reqs[:2]


def test_serve_engine_zero_budget_rejects_at_intake():
    eng = _engine_stub(tenant_budget={"blocked": 0})
    eng.queue = queue_mod.Queue()
    req = Request(uid=0, tokens=np.zeros(4, np.int32), tenant="blocked")
    with pytest.raises(PermissionError, match="blocked"):
        ServeEngine.submit(eng, req)
    assert eng.queue.empty()                  # nothing wedges the drain


# ------------------------------------------------ parity with the reference
@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b",
                                  "qwen2-moe-a2.7b"])
def test_engine_tokens_and_counts_match_the_reference(arch, monkeypatch):
    """5 requests through 2 slots (mid-flight joins), bucket 16: the same
    tokens per request and the same steps, admissions and decoded tokens
    as the reference engine.  Hymba's scans run K3's plain version."""
    calls = []
    scan = ms_ops.selective_scan
    monkeypatch.setattr(ms_ops, "selective_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    jcfg, tcfg, jparams, params = _params(arch, seed=3)
    prompts = _prompts(tcfg, [8 + 3 * i for i in range(5)], seed=5)
    kw = dict(slots=2, max_seq=96, prompt_bucket=16)

    jeng = jengine.ServeEngine(jcfg, jparams, **kw)
    jreqs = [jengine.Request(uid=i, tokens=p, max_new=6)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run_until_drained()

    eng = _engine(tcfg, params, **kw)
    reqs = [Request(uid=i, tokens=p, max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()

    for jr, r in zip(jreqs, reqs):
        np.testing.assert_array_equal(r.output, jr.output,
                                      err_msg=f"request {r.uid}")
    assert (eng.steps, eng.admitted, eng.decoded_tokens) == \
        (jeng.steps, jeng.admitted, jeng.decoded_tokens)
    n_ssm = sum(s.n_layers for s in ttransformer.build_segments(tcfg)
                if s.ssm)
    assert len(calls) == n_ssm * len(prompts)     # one scan a layer a prefill


@pytest.mark.parametrize("arch", jconfigs.names())
def test_kv_cache_rates_match_the_reference(arch):
    assert kv_cache_rates(tconfigs.get(arch)) == \
        jkv_pages.kv_cache_rates(jconfigs.get(arch))


def test_kv_cache_rates_at_full_width():
    """Hymba-1.5B: 32 layers of 5 KV heads of 64 (k and v, bf16) a token;
    its Mamba conv and h state are the fixed part."""
    rates = kv_cache_rates(tconfigs.get("hymba-1.5b"))
    assert rates == {"bytes_per_token": 32 * 2 * 5 * 64 * 2,
                     "fixed_bytes": 7_168_000, "itemsize": 2}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b"])
def test_reused_slot_keeps_nothing_of_its_last_request(arch):
    """A slot that served a long prompt and then a short one holds
    exactly what a fresh slot holds after the short one (the whole row
    is rewritten), and the short prompt decodes to the same tokens as in
    a fresh engine."""
    *_, params = _params(arch, seed=1)
    cfg = tconfigs.get_smoke(arch)
    long, short = _prompts(cfg, (40, 5), seed=2)
    backend = ModelBackend(cfg, params, device="cpu")
    used, fresh = backend.make_state(2, 64), backend.make_state(2, 64)
    backend.splice(used, 1, backend.prefill(long, 40))
    backend.splice(used, 1, backend.prefill(short, 8))
    backend.splice(fresh, 1, backend.prefill(short, 8))
    for cu, cf in zip(used["caches"], fresh["caches"]):
        for k in cu:
            assert torch.equal(cu[k][:, 1], cf[k][:, 1]), k
    assert torch.equal(used["cur_tok"][1], fresh["cur_tok"][1])

    eng = _engine(cfg, params, slots=1, max_seq=64, prompt_bucket=8)
    reqs = [Request(uid=0, tokens=long, max_new=6),
            Request(uid=1, tokens=short, max_new=6)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    (alone,) = _serve_alone(cfg, params, [short], 6, slots=1, max_seq=64,
                            prompt_bucket=8)
    np.testing.assert_array_equal(reqs[1].output, alone)


def test_model_backend_is_not_pickled_into_a_micro_task():
    *_, params = _params("llama3.2-1b")
    backend = ModelBackend(tconfigs.get_smoke("llama3.2-1b"), params,
                           device="cpu")
    with pytest.raises(TypeError, match="not picklable"):
        pickle.dumps(backend.prefill)
    task = MicroTask(0, backend.prefill, (np.arange(4), 8), {},
                     queue="default", tenant=None, tag="prefill")
    assert task._payload is None
    fn, args, _ = task._load()
    assert fn.__self__ is backend and fn.__self__.params is params


def test_model_backend_defaults_to_the_card():
    *_, params = _params("llama3.2-1b")
    cfg = tconfigs.get_smoke("llama3.2-1b")
    if torch.cuda.is_available():
        assert ModelBackend(cfg, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ModelBackend(cfg, params)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, params)


def test_serve_pool_ledger_matches_the_reference():
    """SimBackend at DCN 1e-3 (every splice local) with cold pages
    spooled to the archive: the port's byte ledger equals the
    reference's, reason for reason and link for link."""
    def run(session, devices, describe, cost_model):
        sess = session(devices, cost_model=cost_model)
        sess.cost_model.dcn_cost_per_byte = 1e-3
        try:
            for name in ("d0", "d1", "pf"):
                sess.add_pilot(describe(n_chips=2, name=name,
                                        enable_speculation=False))
            router = sess.serve_pool(
                lambda: SimBackend(prefill_s=1e-3, step_s=2e-4),
                slots=2, max_seq=32, prompt_bucket=8,
                decode_pilots=["pf", "d1"], prefill_pilot="pf",
                bytes_per_token=1 << 10, free_policy="spool")
            _run_pool(sess, router, n=10)
            return sess.dataplane.ledger(), router.snapshot()["kv"]
        finally:
            sess.shutdown()

    want, want_kv = run(JSession, JResourceManager(
        devices=jax.devices() * 6), JPilotDescription, JTransferCostModel())
    got, got_kv = run(Session, ResourceManager(devices=[CPU] * 6),
                      PilotDescription, TransferCostModel())
    assert got["by_reason"] == want["by_reason"]
    assert got["by_link"] == want["by_link"]
    assert got["by_reason"]["kv-spool"] > 0
    assert got_kv == want_kv


def _model_pool(sess, cfg, params, slots=2, **kw):
    return sess.serve_pool(
        lambda: ModelBackend(cfg, params, device="cpu"), slots=slots,
        max_seq=64, prompt_bucket=8, decode_pilots=["pf", "d1"],
        prefill_pilot="pf", cfg=cfg, **kw)


def _check_served(reqs, want, max_new):
    for r, w in zip(reqs, want):
        assert r.done and getattr(r, "error", None) is None, r.uid
        assert r.output is not None and len(r.output) == max_new
        np.testing.assert_array_equal(r.output, w, err_msg=f"uid {r.uid}")


@pytest.mark.parametrize("dcn", [1e-3, 1e-15])
def test_serve_pool_with_the_model_gives_one_engines_tokens(dcn):
    """Prefill as Raptor micro-tasks on ``pf``, pages sized from the
    config, decode on two engines sharing one params tree: every request
    gets the tokens it gets alone in one engine of the same slot count (a
    decode step's rounding depends on its row count).  DCN 1e-3 keeps
    every splice local; at 1e-15 with one slot an engine and load weight
    4 the load term ships pages, and the ledger holds them."""
    *_, params = _params("llama3.2-1b", seed=4)
    cfg = tconfigs.get_smoke("llama3.2-1b")
    prompts = _prompts(cfg, (5, 12, 7, 16, 9, 3), seed=6)
    slots = 2 if dcn > 1e-6 else 1
    want = _serve_alone(cfg, params, prompts, 12, slots=slots, max_seq=64,
                        prompt_bucket=8)
    sess = _serve_session(dcn=dcn)
    try:
        extra = {} if dcn > 1e-6 else {"load_weight": 4.0}
        router = _model_pool(sess, cfg, params, slots=slots, **extra)
        assert all(h.engine.backend.params is params for h in router.handles)
        assert router.kv.bytes_per_token == \
            kv_cache_rates(cfg)["bytes_per_token"]
        reqs = [Request(uid=i, tokens=p, max_new=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            router.submit(r)
        router.drain(timeout_s=120)
        _check_served(reqs, want, 12)
        snap = router.snapshot()
        assert snap["prefill_offloaded"] == len(prompts)
        splice = sess.dataplane.ledger()["by_reason"].get("kv-splice", 0)
        if dcn > 1e-6:
            assert snap["cross_pilot"] == 0
            assert snap["kv"]["local_splices"] == len(prompts)
        else:
            assert snap["cross_pilot"] > 0
            assert splice == snap["splice_bytes"] > 0
    finally:
        sess.shutdown()


def hold_after(handle, n_steps):
    """Let `handle`'s engine take `n_steps` decode steps, then hold its
    next step until the engine is told to stop (its pilot is being
    killed): the kill then lands while its requests are mid-flight."""
    backend = handle.engine.backend
    step, taken = backend.step, []

    def held(*args):
        if len(taken) >= n_steps:
            handle.stop_event.wait(60)
        taken.append(1)
        return step(*args)

    backend.step = held
    return taken


def test_serve_pool_recovers_a_dead_decode_pilot():
    """Kill ``d1`` after two of its decode steps: its requests move to
    ``pf``'s engine, those whose decode state died are prefilled again,
    and every request still gets its one-engine tokens."""
    *_, params = _params("llama3.2-1b", seed=4)
    cfg = tconfigs.get_smoke("llama3.2-1b")
    prompts = _prompts(cfg, (5, 12, 7, 16, 9, 3), seed=7)
    want = _serve_alone(cfg, params, prompts, 24, slots=2, max_seq=64,
                        prompt_bucket=8)
    sess = _serve_session(dcn=1e-15)
    try:
        sess.enable_fault_tolerance(heartbeat_timeout_s=30.0)
        router = _model_pool(sess, cfg, params, load_weight=4.0)
        d1 = sess.pilots["d1"]
        (handle,) = [h for h in router.handles if h.pilot == d1.uid]
        taken = hold_after(handle, 2)
        reqs = [Request(uid=i, tokens=p, max_new=24)
                for i, p in enumerate(prompts)]
        for r in reqs:
            router.submit(r)
        deadline = time.monotonic() + 60
        while len(taken) < 2 and time.monotonic() < deadline:
            time.sleep(1e-3)
        assert handle.engine.n_active, "no request is decoding on d1"
        ev = sess.control_plane.recover_pilot(d1, reason="test")
        assert not sess.control_plane.errors, sess.control_plane.errors
        assert ev.serve_requests_recovered >= 1
        assert router.stats["recovered_requests"] == \
            ev.serve_requests_recovered
        assert [h.pilot for h in router.handles] == [sess.pilots["pf"].uid]
        router.drain(timeout_s=120)
        _check_served(reqs, want, 24)
    finally:
        sess.shutdown()


def test_launch_serve_batch_and_main():
    cfg = tconfigs.get_smoke("llama3.2-1b")
    out = launch_serve.serve_batch(cfg, n_requests=2, prompt_len=8, gen=4,
                                   device="cpu")
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    again = launch_serve.main(["--arch", "llama3.2-1b", "--requests", "2",
                               "--prompt-len", "8", "--gen", "4",
                               "--device", "cpu"])
    np.testing.assert_array_equal(again["tokens"], out["tokens"])
