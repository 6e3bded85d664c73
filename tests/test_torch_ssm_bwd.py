"""The fused backward of the selective scan and its input tail.

The reference differentiates ``_ssm_inputs`` (``a = exp(dt A)``,
``b = (dt x1) B``) and its scan with JAX autodiff.  The port's model
calls ``ops.SelectiveScan`` on (dt, A, u = dt x1, Bc, C, h0), whose
backward is ``ops.ssm_backward``: on CPU tensors its plain version
``ref.ssm_backward``, which the kernel is held against on the card.  Here
the plain version is held against ``jax.vjp`` of the reference's chain
(``exp(dt A)``, ``u B`` and ``repro.kernels.mamba_scan.ref.scan``), the
Function against autograd through the tail plus ``ops.Scan`` (the path it
replaces), and the Function's forward against ``Scan.apply`` bit for bit.
Shapes are K3-bwd's test shapes: a ragged S (not a multiple of the
kernel's 16-step chunk) and st 32 among them.  f32 at 1e-5: the sums run
in other orders (over st, over di for dBc and dC, over B and S for dA).
"""
import unittest.mock

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
NAMES = ("ddt", "dA", "du", "dBc", "dC", "dh0")


def _inputs(B, S, di, st, seed):
    """dt after a softplus (positive), A = -exp(A_log) around -(1..st), u,
    Bc, C, h0 and the cotangents dy, dh_last normal; all f32 numpy."""
    rng = np.random.default_rng(seed)
    arrs = [rng.uniform(0.005, 0.5, (B, S, di)),
            -np.arange(1, st + 1) * rng.uniform(0.5, 1.5, (di, st)),
            rng.normal(size=(B, S, di)),
            rng.normal(size=(B, S, st)),
            rng.normal(size=(B, S, st)),
            rng.normal(size=(B, di, st)) * 0.1,
            rng.normal(size=(B, S, di)),
            rng.normal(size=(B, di, st))]
    return [a.astype(np.float32) for a in arrs]


def _t(x):
    return convert.to_tensor(x)


def _jax_chain(dt, A, u, Bc, C, h0):
    a = jnp.exp(dt[..., None] * A)
    b = u[..., None] * Bc[:, :, None, :]
    return jref.scan(a, b, C, h0)


def _jax_vjp(arrs):
    _, pull = jax.vjp(_jax_chain, *(jnp.asarray(x) for x in arrs[:6]))
    return [np.asarray(g) for g in pull((jnp.asarray(arrs[6]),
                                         jnp.asarray(arrs[7])))]


def _old_path(dt, A, u, Bc, C, h0):
    """Today's tail (``_ssm_inputs``' ops) and the op-level scan."""
    a = torch.exp_(dt[..., None] * A)
    b = u[..., None] * Bc[:, :, None, :]
    return tops.Scan.apply(a, b, C, h0)


@pytest.mark.parametrize("B,S,di,st", SHAPES)
def test_plain_backward_matches_jax_vjp(B, S, di, st):
    arrs = _inputs(B, S, di, st, seed=S * di + st)
    got = tref.ssm_backward(*(_t(x) for x in arrs))
    for g, w, name in zip(got, _jax_vjp(arrs), NAMES):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32)


@pytest.mark.parametrize("B,S,di,st", SHAPES)
def test_function_gradients_match_the_replaced_path(B, S, di, st):
    """The Function's gradients against autograd through the tail plus
    ``ops.Scan`` (whose backward is K3-bwd's plain version here)."""
    arrs = _inputs(B, S, di, st, seed=11 + S + st)
    cot = (_t(arrs[6]), _t(arrs[7]))
    ins = [_t(x).requires_grad_(True) for x in arrs[:6]]
    got = torch.autograd.grad(tops.SelectiveScan.apply(*ins), ins, cot)
    old = [_t(x).requires_grad_(True) for x in arrs[:6]]
    want = torch.autograd.grad(_old_path(*old), old, cot)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **F32)


@pytest.mark.parametrize("B,S,di,st", SHAPES)
def test_function_forward_is_bitwise_the_scan(B, S, di, st):
    arrs = _inputs(B, S, di, st, seed=3 + di)
    ins = [_t(x).requires_grad_(True) for x in arrs[:6]]
    y, h = tops.SelectiveScan.apply(*ins)
    yw, hw = _old_path(*(_t(x) for x in arrs[:6]))
    assert torch.equal(y, yw) and torch.equal(h, hw)
    assert y.grad_fn is not None and h.grad_fn is not None


def test_function_gradients_equal_plain_backward():
    """On CPU tensors the Function's backward is the plain version: its
    gradients equal ``ref.ssm_backward`` bit for bit."""
    arrs = _inputs(2, 64, 16, 8, seed=21)
    ins = [_t(x).requires_grad_(True) for x in arrs[:6]]
    got = torch.autograd.grad(tops.SelectiveScan.apply(*ins), ins,
                              (_t(arrs[6]), _t(arrs[7])))
    for g, w in zip(got, tref.ssm_backward(*(_t(x) for x in arrs))):
        assert torch.equal(g, w)


def test_missing_cotangents_are_zero():
    """dy or dh_last None (an output autograd never reached) is a zero
    cotangent."""
    ts = [_t(x) for x in _inputs(1, 24, 4, 4, seed=12)]
    zero_dh = tref.ssm_backward(*ts[:7], torch.zeros_like(ts[7]))
    for g, w in zip(tref.ssm_backward(*ts[:7], None), zero_dh):
        assert torch.equal(g, w)
    zero_dy = tref.ssm_backward(*ts[:6], torch.zeros_like(ts[6]), ts[7])
    for g, w in zip(tref.ssm_backward(*ts[:6], None, ts[7]), zero_dy):
        assert torch.equal(g, w)


def test_function_returns_none_where_no_grad_is_needed():
    """h0 a constant (as in ``mamba_forward``) gets no gradient; y alone
    reached gives dh_last None to the wrapper."""
    arrs = _inputs(1, 16, 4, 4, seed=2)
    ins = [_t(x).requires_grad_(True) for x in arrs[:5]]
    h0 = _t(arrs[5])
    seen = []
    real = tops.ssm_backward

    def spy(*args):
        seen.append(args[-1] is None)
        return real(*args)

    with unittest.mock.patch.object(tops, "ssm_backward", spy):
        y, _ = tops.SelectiveScan.apply(*ins, h0)
        grads = torch.autograd.grad(y.sum(), ins)
    assert seen == [True]
    assert all(g.shape == x.shape for g, x in zip(grads, ins))


def test_no_graph_under_inference_or_no_grad():
    """Under ``inference_mode`` or ``no_grad`` the Function runs the
    forward wrapper once and records nothing: the same values."""
    arrs = _inputs(1, 16, 4, 4, seed=4)
    ins = [_t(x).requires_grad_(True) for x in arrs[:6]]
    calls = []
    real_scan = tops.selective_scan
    try:
        tops.selective_scan = lambda *a: calls.append(1) or real_scan(*a)
        with torch.inference_mode():
            y1, h1 = tops.SelectiveScan.apply(*ins)
        with torch.no_grad():
            y2, h2 = tops.SelectiveScan.apply(*ins)
    finally:
        tops.selective_scan = real_scan
    assert calls == [1, 1]
    for t in (y1, h1, y2, h2):
        assert t.grad_fn is None and not t.requires_grad
    want = _old_path(*(_t(x) for x in arrs[:6]))
    assert torch.equal(y1, want[0]) and torch.equal(y2, want[0])


def test_wrapper_cpu_path_counts_no_launch():
    ts = [_t(x) for x in _inputs(1, 8, 4, 4, seed=9)]
    before = tops.SSM_BWD_LAUNCHES
    got = tops.ssm_backward(*ts)
    assert tops.SSM_BWD_LAUNCHES == before
    for g, w in zip(got, tref.ssm_backward(*ts)):
        assert torch.equal(g, w)


def test_wrapper_raises_off_cpu_and_cuda():
    """No fallback: a tensor neither on the CPU nor on the card raises."""
    ts = [_t(x).to("meta") for x in _inputs(1, 8, 4, 4, seed=9)]
    with pytest.raises(ValueError, match="unsupported device"):
        tops.ssm_backward(*ts)


@pytest.mark.parametrize("B,S,di,st", [(2, 64, 16, 8), (2, 37, 5, 32)])
def test_function_saves_no_state_sized_tensor(B, S, di, st):
    """The Function keeps nothing of B*S*di*st elements for its backward;
    the path it replaces does (the hook sees a and b there)."""
    arrs = _inputs(B, S, di, st, seed=5)
    big = B * S * di * st

    def largest(fn):
        sizes = []
        ins = [_t(x).requires_grad_(True) for x in arrs[:6]]
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: sizes.append(t.numel()) or t, lambda t: t):
            fn(*ins)
        return max(sizes)

    assert largest(tops.SelectiveScan.apply) < big
    assert largest(_old_path) == big


def test_mamba_layer_gradients_equal_the_replaced_path(monkeypatch):
    """A whole Mamba layer's gradients through the Function against the
    same layer with the tail and ``ops.Scan`` (the path it replaced)."""
    from repro_torch import configs
    from repro_torch.models.layers import mamba
    cfg = configs.get_smoke("hymba-1.5b")
    gen = torch.Generator().manual_seed(1)
    p0 = mamba.init_mamba(cfg, gen)
    x0 = torch.randn(2, 32, cfg.d_model, generator=gen)
    cot = torch.randn(2, 32, cfg.d_model, generator=gen)

    def grads():
        names = sorted(p0)
        leaves = [p0[k].detach().clone().requires_grad_(True) for k in names]
        x = x0.clone().requires_grad_(True)
        out, _ = mamba.mamba_forward(cfg, dict(zip(names, leaves)), x)
        return out, torch.autograd.grad((out * cot).sum(), leaves + [x])

    out, got = grads()
    with monkeypatch.context() as m:
        m.setattr(tops.SelectiveScan, "apply", _old_path)
        out_old, want = grads()
    assert torch.equal(out, out_old)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)
