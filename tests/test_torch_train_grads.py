"""Gradients of the port's model stack against JAX autodiff, for every
architecture of ``configs.names()`` on its smoke config.

The reference's params (``init_params``, converted jax -> numpy ->
torch) and one ``TokenPipeline`` batch go through
``jax.value_and_grad(repro...loss_fn)`` (its default ``remat=True``) and
the port's ``loss_fn(...)`` under ``torch.autograd.grad``, with
``remat=True`` and ``remat=False``; every Mamba scan's gradient is K3's
plain backward here.  The loss is held at 1e-5, every gradient leaf at
rtol 1e-4 / atol 1e-6 of the reference's, and ``remat=True`` gives the
same gradients as ``remat=False`` inside the port, bit for bit (the
recompute repeats the forward's ops).  The reference is jitted once per
arch (a module-scoped fixture).
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import transformer as jtransformer

from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, to_numpy, to_tensor
from repro_torch.models import transformer as ttransformer
from repro_torch.train.step import value_and_grad
from repro_torch.util import tree_paths

ARCHS = jconfigs.names()
B, S = 2, 32
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def reference():
    """arch -> (numpy params, numpy batch, loss, {path: numpy grad})."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jconfigs.get_smoke(arch)
            params = jtransformer.init_params(cfg, jax.random.key(3))
            batch = JPipeline(cfg, batch=B, seq=S, seed=3).batch_at(0)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: jtransformer.loss_fn(cfg, p, b)))(params, batch)
            cache[arch] = (jax.tree.map(np.asarray, params),
                           {k: np.asarray(v) for k, v in batch.items()},
                           float(loss),
                           dict(tree_paths(jax.tree.map(np.asarray, grads))))
        return cache[arch]
    return get


def _port_grads(arch, params_np, batch_np, remat):
    cfg = tconfigs.get_smoke(arch)
    params = params_from_numpy(params_np, "cpu")
    batch = {k: to_tensor(v) for k, v in batch_np.items()}
    return value_and_grad(
        lambda p: ttransformer.loss_fn(cfg, p, batch, remat=remat), params)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_value_and_grad(reference, arch, remat):
    params_np, batch_np, want_loss, want = reference(arch)
    loss, grads = _port_grads(arch, params_np, batch_np, remat)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = dict(tree_paths(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        g = to_numpy(got[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32),
                                   err_msg="/".join(map(str, path)),
                                   **GRAD_TOL)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen2-moe-a2.7b",
                                  "seamless-m4t-medium"])
def test_remat_gives_the_same_gradients(reference, arch):
    params_np, batch_np, _, _ = reference(arch)
    l1, g1 = _port_grads(arch, params_np, batch_np, True)
    l2, g2 = _port_grads(arch, params_np, batch_np, False)
    assert torch.equal(l1, l2)
    for (p, a), (_, b) in zip(tree_paths(g1), tree_paths(g2)):
        assert torch.equal(a, b), p


def test_remat_policy_raises():
    cfg = tconfigs.get_smoke("llama3.2-1b")
    with pytest.raises(NotImplementedError, match="remat_policy"):
        ttransformer.loss_fn(cfg, {}, {}, remat_policy="save_tp_out")


def test_chunked_loss_matches_jax_grads():
    """Above LOSS_CHUNK the CE runs in checkpointed chunks: the loss and
    the unembedding's gradient still match the reference's."""
    arch = "llama3.2-1b"
    jcfg = jconfigs.get_smoke(arch)
    params = jtransformer.init_params(jcfg, jax.random.key(4))
    seq = 2 * jtransformer.LOSS_CHUNK
    batch = JPipeline(jcfg, batch=1, seq=seq, seed=4).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(jcfg, p, b)))(params, batch)
    tl, tg = _port_grads(arch, jax.tree.map(np.asarray, params),
                         {k: np.asarray(v) for k, v in batch.items()}, True)
    np.testing.assert_allclose(float(tl), float(loss), rtol=1e-5)
    want = dict(tree_paths(jax.tree.map(np.asarray, grads)))
    for path, g in tree_paths(tg):
        np.testing.assert_allclose(to_numpy(g), want[path], **GRAD_TOL)


def test_chunked_attention_grads_match_unchunked():
    """``chunked_sdpa`` recomputes each score block in backward: its
    gradients equal plain ``sdpa``'s to f32 rounding."""
    from repro_torch.models.layers import attention
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 16, generator=gen).requires_grad_(True)
               for _ in range(3))
    pos = torch.arange(64)
    out_c = attention.chunked_sdpa(q, k, v, pos, pos, causal=True, window=24,
                                   q_chunk=16, kv_chunk=16)
    cot = torch.randn(out_c.shape, generator=gen)
    got = torch.autograd.grad(out_c, (q, k, v), cot)
    out = attention.sdpa(q, k, v, pos, pos, causal=True, window=24)
    want = torch.autograd.grad(out, (q, k, v), cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)
