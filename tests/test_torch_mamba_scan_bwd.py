"""The backward of the selective scan (K3-bwd) against JAX autodiff.

The reference has no backward kernel: its model differentiates its scan
with JAX.  So the port's plain backward (``ref.scan_backward``, what the
wrapper runs for CPU tensors and what K3-bwd is held against on the
card) is held against ``jax.vjp`` of the reference's ``ref.scan`` and
against ``torch.autograd`` through the port's ``ref.scan``, on the same
numpy inputs and cotangents: at the reference's K3 test shapes and a
ragged one (st 32, S not a multiple of K3-bwd's 16-step chunk), f32 at
1e-5.  bf16 inputs are held at the reference's bf16 tolerance (2e-2,
``tests/test_kernels.py``) against the f32 vjp of their upcast values:
the port upcasts, carries h and g in f32 and rounds the results to bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ref as jref

from repro_torch import convert
from repro_torch.kernels.mamba_scan import ops as tops
from repro_torch.kernels.mamba_scan import ref as tref

SHAPES = [(1, 32, 8, 4), (2, 64, 16, 8), (1, 128, 32, 16), (1, 40, 8, 2),
          (2, 37, 5, 32)]
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(B, S, di, st, seed):
    """a in (0.7, 0.999) like exp(dt * A) with A < 0; b, C, h0 and the
    cotangents dy, dh_last normal; all f32 numpy."""
    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(0.7, 0.999, (B, S, di, st)),
            rng.normal(size=(B, S, di, st)) * 0.1,
            rng.normal(size=(B, S, st)),
            rng.normal(size=(B, di, st)) * 0.1,
            rng.normal(size=(B, S, di)),
            rng.normal(size=(B, di, st))]
    return [a.astype(np.float32) for a in arrs]


def _jax_vjp(a, b, C, h0, dy, dh):
    _, pull = jax.vjp(jref.scan, *(jnp.asarray(x) for x in (a, b, C, h0)))
    return [np.asarray(g) for g in pull((jnp.asarray(dy), jnp.asarray(dh)))]


def _t(x):
    return convert.to_tensor(x)


@pytest.mark.parametrize("B,S,di,st", SHAPES)
def test_plain_backward_matches_jax_vjp(B, S, di, st):
    arrs = _inputs(B, S, di, st, seed=S * di + st)
    got = tref.scan_backward(*(_t(x) for x in arrs))
    for g, w, name in zip(got, _jax_vjp(*arrs), ("da", "db", "dC", "dh0")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32)


@pytest.mark.parametrize("B,S,di,st", SHAPES)
def test_plain_backward_matches_autograd(B, S, di, st):
    arrs = _inputs(B, S, di, st, seed=7 + S)
    ins = [_t(x).requires_grad_(True) for x in arrs[:4]]
    y, h = tref.scan(*ins)
    want = torch.autograd.grad((y, h), ins, (_t(arrs[4]), _t(arrs[5])))
    got = tref.scan_backward(*(_t(x) for x in arrs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)


def test_plain_backward_bf16_inputs():
    arrs = _inputs(2, 64, 16, 8, seed=3)
    bf = [_t(x).to(torch.bfloat16) for x in arrs[:4]]
    got = tref.scan_backward(*bf, _t(arrs[4]), _t(arrs[5]))
    assert all(g.dtype == torch.bfloat16 for g in got)
    up = [x.float().numpy() for x in bf]
    for g, w in zip(got, _jax_vjp(*up, arrs[4], arrs[5])):
        np.testing.assert_allclose(g.float().numpy(), w, **BF16)


def test_missing_cotangents_are_zero():
    """dy or dh_last None (an output autograd never reached) is a zero
    cotangent."""
    arrs = _inputs(1, 24, 4, 4, seed=11)
    ts = [_t(x) for x in arrs]
    zero_dh = tref.scan_backward(*ts[:4], ts[4], torch.zeros_like(ts[5]))
    for g, w in zip(tref.scan_backward(*ts[:4], ts[4], None), zero_dh):
        assert torch.equal(g, w)
    zero_dy = tref.scan_backward(*ts[:4], torch.zeros_like(ts[4]), ts[5])
    for g, w in zip(tref.scan_backward(*ts[:4], None, ts[5]), zero_dy):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,S,di,st", SHAPES[:3])
def test_function_gradients_equal_plain_backward(B, S, di, st):
    """On CPU tensors the autograd Function's backward is the plain
    version: its gradients equal ``ref.scan_backward`` bit for bit."""
    arrs = _inputs(B, S, di, st, seed=5 + di)
    ins = [_t(x).requires_grad_(True) for x in arrs[:4]]
    y, h = tops.Scan.apply(*ins)
    assert y.grad_fn is not None and h.grad_fn is not None
    got = torch.autograd.grad((y, h), ins, (_t(arrs[4]), _t(arrs[5])))
    want = tref.scan_backward(*(_t(x) for x in arrs))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_function_returns_none_where_no_grad_is_needed():
    """h0 a constant (as in ``mamba_forward``): no gradient for it, and the
    wrapper is asked for none."""
    arrs = _inputs(1, 16, 4, 4, seed=2)
    a, b, C = (_t(x).requires_grad_(True) for x in arrs[:3])
    h0 = _t(arrs[3])
    asked = []
    real = tops.scan_backward

    def spy(*args, need):
        asked.append(tuple(need))
        return real(*args, need=need)

    import unittest.mock
    with unittest.mock.patch.object(tops, "scan_backward", spy):
        y, _ = tops.Scan.apply(a, b, C, h0)
        ga, gb, gC = torch.autograd.grad(y.sum(), (a, b, C))
    assert asked == [(True, True, True, False)]
    assert ga.shape == a.shape and gC.shape == C.shape


def test_no_graph_under_inference_or_no_grad():
    """Under ``inference_mode`` or ``no_grad`` the Function runs the
    forward wrapper once and records nothing: the same values."""
    arrs = _inputs(1, 16, 4, 4, seed=4)
    ins = [_t(x).requires_grad_(True) for x in arrs[:4]]
    calls = []
    real_scan = tops.scan
    try:
        tops.scan = lambda *a: calls.append(1) or real_scan(*a)
        with torch.inference_mode():
            y1, h1 = tops.Scan.apply(*ins)
        with torch.no_grad():
            y2, h2 = tops.Scan.apply(*ins)
    finally:
        tops.scan = real_scan
    assert calls == [1, 1]
    for t in (y1, h1, y2, h2):
        assert t.grad_fn is None and not t.requires_grad
    want = tref.scan(*(_t(x) for x in arrs[:4]))
    assert torch.equal(y1, want[0]) and torch.equal(y2, want[0])


def test_wrapper_cpu_path_counts_no_launch():
    """On the CPU the wrapper runs the plain version and counts nothing;
    `need` masks the results."""
    arrs = _inputs(1, 8, 4, 4, seed=9)
    before = tops.BWD_LAUNCHES
    got = tops.scan_backward(*(_t(x) for x in arrs),
                             need=(True, False, True, False))
    assert tops.BWD_LAUNCHES == before
    assert got[1] is None and got[3] is None
    want = tref.scan_backward(*(_t(x) for x in arrs))
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])


def test_mamba_layer_gradient_goes_through_the_function(monkeypatch):
    """``mamba_forward`` routes its scan through the Function: a spy on
    the fused backward's wrapper (``ssm_backward``, the gradient of the
    scan and its input tail) sees one call per backward pass, and the
    op-level scan's backward none."""
    from repro_torch import configs
    from repro_torch.models.layers import mamba
    cfg = configs.get_smoke("falcon-mamba-7b")
    gen = torch.Generator().manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in
         mamba.init_mamba(cfg, gen).items()}
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    calls, op_calls = [], []
    real, real_op = tops.ssm_backward, tops.scan_backward
    monkeypatch.setattr(tops, "ssm_backward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tops, "scan_backward",
                        lambda *a, **k: op_calls.append(1) or real_op(*a, **k))
    out, _ = mamba.mamba_forward(cfg, p, x)
    out.sum().backward()
    assert calls == [1] and op_calls == []
    for k in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
              "A_log"):
        assert p[k].grad is not None and bool(p[k].grad.abs().sum() > 0), k
