"""K3 and the fused Mamba backward under fake tensors.

The dry-run traces a step under ``FakeTensorMode``.  The two wrappers
hand raw pointers to their kernels, so each has a shape rule that fires
for ``FakeTensor`` inputs only:

* a Mamba layer's forward and backward on fake ``cpu`` tensors, and
  each wrapper (K3, K3-bwd, the fused backward) on fake ``cuda`` and
  ``cpu`` tensors, give outputs and gradients of the right shapes and
  dtypes and launch nothing: ``LAUNCHES``, ``SSM_BWD_LAUNCHES`` and
  ``BWD_LAUNCHES`` stay 0, and no plain version is called.  (A
  CPU-only build cannot run a model on fake ``cuda`` tensors: indexing
  one, or recording autograd on one, asks for the CUDA runtime.  The
  card's dry-run, ``chip_smoke.py`` phase 15c, runs the whole step on
  them);
* ``FlopCounterMode`` counts the scan as ``roofline.analytic`` does (the
  associative-scan and C readout terms; twice that for the backward);
* meta tensors still raise, and real CPU tensors still take the plain
  version (``test_torch_ssm_bwd.py`` holds the same for the backward).
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.kernels.mamba_scan import ops, ref
from repro_torch.models.layers import mamba

ARCH = "hymba-1.5b"
B, S = 2, 32


@pytest.fixture
def counted(monkeypatch):
    """Zeroed launch counts and counters on the plain versions."""
    calls = {"scan": 0, "scan_backward": 0, "ssm_backward": 0}
    for name in calls:
        real = getattr(ref, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(ref, name, wrapped)
    monkeypatch.setattr(ops, "LAUNCHES", 0)
    monkeypatch.setattr(ops, "BWD_LAUNCHES", 0)
    monkeypatch.setattr(ops, "SSM_BWD_LAUNCHES", 0)
    return calls


def _launches():
    return ops.LAUNCHES, ops.BWD_LAUNCHES, ops.SSM_BWD_LAUNCHES


def _fake_layer(device: str):
    """A fake Mamba layer's params and input on `device`."""
    cfg = configs.get_smoke(ARCH)
    p = mamba.init_mamba(cfg, torch.Generator())
    p = {k: torch.empty_like(v, device=device).requires_grad_(True)
         for k, v in p.items()}
    x = torch.empty(B, S, cfg.d_model, dtype=cfg.param_dtype, device=device,
                    requires_grad=True)
    return cfg, p, x


def test_mamba_layer_under_fake_tensors_launches_nothing(counted):
    device = "cpu"
    with FakeTensorMode():
        cfg, p, x = _fake_layer(device)
        out, cache = mamba.mamba_forward(cfg, p, x)
        grads = torch.autograd.grad(out.float().sum(), [x, *p.values()])
    assert isinstance(out, FakeTensor) and out.device.type == device
    assert tuple(out.shape) == tuple(x.shape) and out.dtype == x.dtype
    assert tuple(cache["h"].shape) == (B, cfg.ssm_d_inner, cfg.ssm_d_state)
    assert cache["h"].dtype == torch.float32
    for g, t in zip(grads, [x, *p.values()]):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert g.device.type == device
    assert _launches() == (0, 0, 0)
    assert counted == {"scan": 0, "scan_backward": 0, "ssm_backward": 0}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_op_level_scan_and_backward_under_fake_tensors(device, counted):
    di, st = 8, 4
    with FakeTensorMode():
        a, b = (torch.empty(B, S, di, st, device=device) for _ in range(2))
        C = torch.empty(B, S, st, device=device)
        h0 = torch.empty(B, di, st, device=device)
        y, h = ops.scan(a, b, C, h0)
        dy = torch.empty(B, S, di, device=device)
        da, db, dC, dh0 = ops.scan_backward(a, b, C, h0, dy, None,
                                            need=(True, True, False, True))
        dt, u = (torch.empty(B, S, di, device=device) for _ in range(2))
        A = torch.empty(di, st, device=device)
        fused = ops.ssm_backward(dt, A, u, C, C, h0, dy, None)
    assert [g.shape for g in fused] == [t.shape for t in (dt, A, u, C, C, h0)]
    assert all(g.dtype == torch.float32 and g.device.type == device
               for g in fused)
    assert (tuple(y.shape), tuple(h.shape)) == ((B, S, di), (B, di, st))
    assert y.dtype == h.dtype == torch.float32
    assert dC is None and da.shape == a.shape and dh0.shape == h0.shape
    assert _launches() == (0, 0, 0) and sum(counted.values()) == 0


def test_flop_counter_counts_the_scan_as_the_analytic_model():
    cfg = configs.get_smoke(ARCH)
    di, st = cfg.ssm_d_inner, cfg.ssm_d_state
    fwd = 3 * 5 * B * S * di * st + 2 * B * S * di * st
    with FakeTensorMode():
        _, p, x = _fake_layer("cpu")
        with FlopCounterMode(display=False) as counter:
            out, _ = mamba.mamba_forward(cfg, p, x)
        scan_fwd = counter.get_flop_counts()["Global"][
            torch.ops.repro_torch.selective_scan_cost]
        with FlopCounterMode(display=False) as counter:
            torch.autograd.grad(out.float().sum(), [x])
        scan_bwd = counter.get_flop_counts()["Global"][
            torch.ops.repro_torch.selective_scan_cost]
    assert scan_fwd == fwd
    assert scan_bwd == 2 * fwd


def test_flop_counter_sees_the_plain_scan_on_real_tensors(counted):
    di, st = 8, 4
    g = torch.Generator().manual_seed(0)
    a, b = (torch.rand(B, 4, di, st, generator=g) for _ in range(2))
    C, h0 = torch.rand(B, 4, st, generator=g), torch.zeros(B, di, st)
    with FlopCounterMode(display=False) as counter:
        y, _ = ops.scan(a, b, C, h0)
    want, _ = ref.scan(a, b, C, h0)
    assert torch.equal(y, want) and counted["scan"] == 2
    assert counter.get_total_flops() == 17 * B * 4 * di * st


def test_meta_tensors_still_raise():
    a, b = (torch.empty(B, S, 8, 4, device="meta") for _ in range(2))
    C, h0 = torch.empty(B, S, 4, device="meta"), torch.empty(
        B, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.scan(a, b, C, h0)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.scan_backward(a, b, C, h0, None, None)
