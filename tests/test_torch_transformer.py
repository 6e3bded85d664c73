"""Parity of the port's transformer stack with the JAX reference, for every
architecture of ``configs.names()`` on its smoke config.

The reference's params (``init_params``, converted jax -> numpy -> torch)
and one ``make_batch`` seed go through both packages on the CPU: the
forward logits and ``loss_fn`` (1e-4), the prefill logits and caches
(1e-4), and a teacher-forced decode chain after the prompt, held against
the reference's decode logits (1e-4) and against the port's own forward
(2e-3, the reference's tolerance in ``tests/test_arch_smoke.py``).  The
reference's outputs are built once per arch (a module-scoped fixture),
jitted as ``tests/test_arch_smoke.py`` jits its decode step.  One bf16
arch is held at 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import batches as jbatches
from repro.models import transformer as jtransformer

from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import batches as tbatches
from repro_torch.models import transformer as ttransformer

ARCHS = jconfigs.names()
B, S_TOTAL, PROMPT, MAX_SEQ = 2, 48, 40, 64
TOL = dict(rtol=1e-4, atol=1e-4)


def _prompt_len(cfg):
    """Text tokens in the prompt (vision archs prepend frontend tokens)."""
    return PROMPT - (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)


def _reference(cfg):
    """The reference's params, batch and outputs for one arch."""
    params = jtransformer.init_params(cfg, jax.random.key(2))
    batch = jbatches.make_batch(cfg, "train", B, S_TOTAL,
                                np.random.default_rng(2))
    (logits, aux), loss = jax.jit(lambda p, b: (
        jtransformer.forward(cfg, p, b, remat=False),
        jtransformer.loss_fn(cfg, p, b, remat=False)))(params, batch)
    tp = _prompt_len(cfg)
    pre = {k: (v[:, :tp] if k == "tokens" else v)
           for k, v in batch.items() if k not in ("labels", "mask")}
    caches, last = jax.jit(
        lambda p, b: jtransformer.prefill(cfg, p, b))(params, pre)
    enc_len = batch["frame_embeds"].shape[1] if cfg.is_encoder_decoder else 0
    grown = jax.eval_shape(
        lambda: jtransformer.init_caches(cfg, B, MAX_SEQ, enc_len))
    dec = jax.tree.map(lambda buf, spec: jnp.pad(
        buf, [(0, t - s) for s, t in zip(buf.shape, spec.shape)]),
        caches, grown)
    step = jax.jit(lambda c, t, p: jtransformer.decode_step(cfg, params, c,
                                                            t, p))
    n_front = PROMPT - tp
    steps = []
    for t in range(tp, batch["tokens"].shape[1]):
        dec, lg = step(dec, batch["tokens"][:, t:t + 1],
                       jnp.full((B,), n_front + t, jnp.int32))
        steps.append(np.asarray(lg))
    np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"params": np_(params), "batch": np_(batch),
            "logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "caches": np_(caches),
            "last": np.asarray(last), "steps": steps, "enc_len": enc_len}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    jcfg, tcfg = jconfigs.get_smoke(name), tconfigs.get_smoke(name)
    ref = _reference(jcfg)
    params = params_from_numpy(ref["params"], "cpu")
    batch = tbatches.make_batch(tcfg, "train", B, S_TOTAL,
                                np.random.default_rng(2), device="cpu")
    logits, aux = ttransformer.forward(tcfg, params, batch)
    return {"name": name, "cfg": tcfg, "ref": ref, "params": params,
            "batch": batch, "logits": logits, "aux": aux}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               want, **(tol or TOL))


def test_init_params_has_the_reference_tree(arch):
    """Same tree, shapes and dtypes as the reference's init_params."""
    got = params_to_numpy(ttransformer.init_params(
        arch["cfg"], torch.Generator().manual_seed(0), device="cpu"))
    want = arch["ref"]["params"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)


def test_make_batch_matches_the_reference(arch):
    for k, v in arch["ref"]["batch"].items():
        got = arch["batch"][k].numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_forward_and_loss(arch):
    cfg, ref = arch["cfg"], arch["ref"]
    assert tuple(arch["logits"].shape) == (B, S_TOTAL, cfg.vocab_padded)
    assert bool(torch.isfinite(arch["logits"]).all())
    _close(arch["logits"], ref["logits"])
    _close(arch["aux"].item(), ref["aux"])
    loss = ttransformer.loss_fn(cfg, arch["params"], arch["batch"])
    assert loss.shape == () and bool(torch.isfinite(loss))
    _close(loss.item(), ref["loss"])


def test_prefill_logits_and_caches(arch):
    cfg, ref = arch["cfg"], arch["ref"]
    tp = _prompt_len(cfg)
    pre = {k: (v[:, :tp] if k == "tokens" else v)
           for k, v in arch["batch"].items() if k not in ("labels", "mask")}
    caches, last = ttransformer.prefill(cfg, arch["params"], pre)
    _close(last, ref["last"])
    got, want = params_to_numpy(caches), ref["caches"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w)


def test_decode_chain_matches_reference_and_own_forward(arch):
    """Prefill the prompt, grow the caches to MAX_SEQ, then feed the rest
    of the batch one token at a time (teacher forcing)."""
    cfg, ref = arch["cfg"], arch["ref"]
    tp = _prompt_len(cfg)
    n_front = PROMPT - tp
    pre = {k: (v[:, :tp] if k == "tokens" else v)
           for k, v in arch["batch"].items() if k not in ("labels", "mask")}
    caches, _ = ttransformer.prefill(cfg, arch["params"], pre)
    caches = ttransformer.grow_caches(caches, ttransformer.init_caches(
        cfg, B, MAX_SEQ, ref["enc_len"], device="cpu"))
    tokens = arch["batch"]["tokens"]
    V = cfg.vocab_size
    assert len(ref["steps"]) == tokens.shape[1] - tp > 0
    for i, t in enumerate(range(tp, tokens.shape[1])):
        caches, logits = ttransformer.decode_step(
            cfg, arch["params"], caches, tokens[:, t:t + 1],
            torch.full((B,), n_front + t, dtype=torch.int32))
        _close(logits, ref["steps"][i], err_msg=f"step {t}", **TOL)
        _close(logits[:, 0, :V], arch["logits"][:, n_front + t, :V].numpy(),
               rtol=2e-3, atol=2e-3, err_msg=f"step {t} vs forward")


@pytest.mark.parametrize("name", ["llama3.2-1b", "hymba-1.5b"])
def test_loss_over_sequence_chunks(name):
    """S = 1024 > LOSS_CHUNK: the unembed + cross-entropy runs per chunk
    of 512 positions, with a mask that drops some of them."""
    jcfg, tcfg = jconfigs.get_smoke(name), tconfigs.get_smoke(name)
    assert 1024 > ttransformer.LOSS_CHUNK == jtransformer.LOSS_CHUNK
    jparams = jtransformer.init_params(jcfg, jax.random.key(6))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (1, 1024)),
             "labels": rng.integers(0, jcfg.vocab_size, (1, 1024)),
             "mask": (rng.random((1, 1024)) < 0.8).astype(np.float32)}
    want = jtransformer.loss_fn(jcfg, jparams, {
        k: jnp.asarray(v, jnp.float32 if k == "mask" else jnp.int32)
        for k, v in batch.items()}, remat=False)
    got = ttransformer.loss_fn(tcfg, params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got.item(), float(want))


@pytest.mark.parametrize("name", ["hymba-1.5b", "llama3.2-1b"])
def test_bf16_forward_and_prefill(name):
    """The same stack in bf16 (params and activations), held at 5e-2."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(name), dtype="bfloat16")
    tcfg = dataclasses.replace(tconfigs.get_smoke(name), dtype="bfloat16")
    jparams = jtransformer.init_params(jcfg, jax.random.key(5))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert params["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, 32))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks).to(torch.int32)}
    want, _ = jtransformer.forward(jcfg, jparams, jb, remat=False)
    got, _ = ttransformer.forward(tcfg, params, tb)
    _close(got, np.asarray(want), rtol=5e-2, atol=5e-2)
    _, jlast = jtransformer.prefill(jcfg, jparams, jb)
    caches, last = ttransformer.prefill(tcfg, params, tb)
    _close(last, np.asarray(jlast), rtol=5e-2, atol=5e-2)
    if tcfg.family == "hybrid":
        assert caches[0]["h"].dtype == torch.float32
        assert caches[0]["k"].dtype == torch.bfloat16


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """The default device is CUDA: without a card the entry points raise
    (no fallback to the CPU); with one, they place their tensors there."""
    cfg = tconfigs.get_smoke("llama3.2-1b")
    calls = [lambda: ttransformer.init_params(cfg),
             lambda: ttransformer.init_caches(cfg, 1, 8),
             lambda: tbatches.make_batch(cfg, "prefill", 1, 8,
                                         np.random.default_rng(0))]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            leaf = jax.tree.leaves(out, is_leaf=torch.is_tensor)[0]
            assert leaf.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
