"""Parity of the port's selective-scan wrapper with the JAX reference.

The same numpy inputs go through ``repro`` (its ``lax.scan`` oracle and
its Pallas kernel in interpret mode) and ``repro_torch`` (on the CPU the
wrapper runs its plain version).  Tolerance 1e-4, the reference's own
(``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.mamba_scan import ops as jops  # noqa: E402
from repro.kernels.mamba_scan import ref as jref  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import autotune as tat  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan as tker  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as tops  # noqa: E402
from repro_torch.kernels.mamba_scan import ref as tref  # noqa: E402


def _inputs(B, S, di, st_, seed, dtype=jnp.float32, lo=0.7, hi=0.999):
    """Reference arrays and the port's tensors holding the same values;
    decays in (0, 1) like exp(dt * A) with A < 0."""
    rng = np.random.default_rng(seed)
    arrays = [rng.uniform(lo, hi, size=(B, S, di, st_)),
              rng.normal(size=(B, S, di, st_)) * 0.1,
              rng.normal(size=(B, S, st_)),
              rng.normal(size=(B, di, st_)) * 0.1]
    js = [jnp.asarray(a.astype(np.float32), dtype) for a in arrays]
    return js, [convert.to_tensor(np.asarray(j)) for j in js]


def _close(got, exp):
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e, np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,S,di,st_", [(1, 32, 8, 4), (2, 64, 16, 8),
                                        (1, 128, 32, 16), (1, 40, 8, 2)])
def test_scan_matches_reference_and_pallas(B, S, di, st_):
    js, ts = _inputs(B, S, di, st_, seed=S + di)
    y, h_last = tops.scan(*ts)
    assert y.shape == (B, S, di) and h_last.shape == (B, di, st_)
    _close((y, h_last), jref.scan(*js))
    _close((y, h_last), jops.scan(*js, bdi=min(8, di), bs=min(16, S)))


def test_scan_odd_shapes():
    """S = 48, di = 24, st = 8: no default block divides d_inner."""
    js, ts = _inputs(1, 48, 24, 8, seed=1)
    got = tops.scan(*ts)
    _close(got, jref.scan(*js))
    _close(got, jops.scan(*js))


def test_scan_bf16_inputs_give_f32_outputs():
    js, ts = _inputs(2, 32, 8, 4, seed=2, dtype=jnp.bfloat16)
    y, h_last = tops.scan(*ts)
    assert y.dtype == torch.float32 and h_last.dtype == torch.float32
    _close((y, h_last), jops.scan(*js, bdi=8, bs=8))


@settings(max_examples=10, deadline=None)
@given(B=st.integers(1, 3), S=st.integers(1, 40), di=st.integers(1, 20),
       st_=st.sampled_from([2, 4, 8, 16]), seed=st.integers(0, 2**31))
def test_scan_property(B, S, di, st_, seed):
    """Plain version == the reference's sequential recurrence for any
    (B, S, di, st), no divisibility needed."""
    js, ts = _inputs(B, S, di, st_, seed=seed, lo=0.5, hi=1.0)
    _close(tops.scan(*ts), jref.scan(*js))


def test_scan_plain_version_is_the_cpu_path():
    _, ts = _inputs(1, 16, 4, 4, seed=5)
    for a, b in zip(tops.scan(*ts, bdi=2, bs=4), tref.scan(*ts)):
        assert torch.equal(a, b)


def test_scan_refuses_devices_it_has_no_kernel_for():
    a = torch.empty((1, 4, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.scan(a, a, a[:, :, 0], a[:, 0])


def test_block_threads_and_defaults():
    # a d_inner row takes st rounded up to a power of two lanes; a block
    # is whole warps
    assert [tker.state_lanes(s) for s in (1, 2, 3, 8, 9, 16, 32)] == \
        [2, 2, 4, 8, 16, 16, 32]
    assert tker.threads(8, 16) == 128 and tker.threads(3, 4) == 32
    d = tat.DEFAULTS["mamba_scan"]
    assert d["bs"] in tker.BS_BUILT
    assert tker.threads(d["bdi"], tker.MAX_ST) <= tker.MAX_THREADS


# ------------------------------------------------ K3's fused mode, CPU path
FUSED_SHAPES = [(1, 32, 8, 4), (2, 64, 16, 8), (1, 128, 32, 16),
                (1, 40, 8, 2), (2, 37, 13, 1), (1, 45, 7, 5),
                (3, 21, 9, 16), (1, 19, 11, 32)]


def _fused_inputs(B, S, di, st_, seed):
    """A Mamba layer's scan inputs as torch f32: dt after a softplus,
    A = -exp(A_log) < 0, u = dt x1, Bc, C and h0."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.005, 0.5, (B, S, di))
    arrs = [dt, -np.arange(1, st_ + 1) * rng.uniform(0.5, 1.5, (di, st_)),
            dt * rng.normal(size=(B, S, di)), rng.normal(size=(B, S, st_)),
            rng.normal(size=(B, S, st_)), rng.normal(size=(B, di, st_)) * 0.1]
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


@pytest.mark.parametrize("B,S,di,st_", FUSED_SHAPES)
def test_selective_scan_cpu_is_the_tail_then_the_plain_scan(B, S, di, st_):
    """On the CPU: exp(dt A) and u Bc with the model's ops, then the
    plain scan, bit for bit; and the reference's scan within 1e-4."""
    dt, A, u, Bc, C, h0 = _fused_inputs(B, S, di, st_, seed=S * di + st_)
    got = tops.selective_scan(dt, A, u, Bc, C, h0)
    a = torch.exp(dt[..., None] * A)
    b = u[..., None] * Bc[:, :, None, :]
    want = tref.scan(a, b, C, h0)
    assert got[0].shape == (B, S, di) and got[1].shape == (B, di, st_)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    js = [jnp.asarray(t.numpy()) for t in (a, b, C, h0)]
    _close(got, jref.scan(*js))


def test_selective_scan_on_the_cpu_counts_no_launch(monkeypatch):
    monkeypatch.setattr(tops, "LAUNCHES", 0)
    monkeypatch.setattr(tops, "FUSED_LAUNCHES", 0)
    args = _fused_inputs(1, 16, 4, 4, seed=6)
    tops.selective_scan(*args)
    tops.selective_scan(*args, bdi=8, bs=16)
    tops.SelectiveScan.apply(*args)
    assert (tops.LAUNCHES, tops.FUSED_LAUNCHES) == (0, 0)


def test_selective_scan_refuses_devices_it_has_no_kernel_for():
    dt = torch.empty((1, 4, 2), device="meta")
    A = torch.empty((2, 4), device="meta")
    C = torch.empty((1, 4, 4), device="meta")
    h0 = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.selective_scan(dt, A, dt, C, C, h0)


def test_selective_scan_function_forward_never_runs_the_ab_mode(
        monkeypatch):
    """SelectiveScan's forward reaches selective_scan (K3's fused mode
    on the card), never scan on materialized a and b; with a graph and
    without one."""
    calls = []
    real = tops.selective_scan

    def spy(*ts, **kw):
        calls.append(len(ts))
        return real(*ts, **kw)

    def refuse(*_a, **_k):
        raise AssertionError("SelectiveScan ran ops.scan")

    monkeypatch.setattr(tops, "selective_scan", spy)
    monkeypatch.setattr(tops, "scan", refuse)
    ins = [t.requires_grad_(True) for t in _fused_inputs(2, 24, 6, 8, 7)]
    y, h = tops.SelectiveScan.apply(*ins)
    (y.sum() + h.sum()).backward()
    with torch.no_grad():
        tops.SelectiveScan.apply(*ins)
    assert calls == [6, 6]
    assert all(t.grad is not None for t in ins)


def test_fused_block_layout_and_defaults():
    # a row's states, at most 4 to a lane; a block is whole warps
    assert [tker.fused_lanes(s) for s in (1, 2, 3, 4, 5, 8, 9, 16, 32)] == \
        [(1, 2), (1, 2), (1, 4), (1, 4), (2, 4), (2, 4), (4, 4), (4, 4),
         (8, 4)]
    assert tker.fused_threads(16, 16) == 64 and tker.fused_threads(4, 4) == 32
    assert tker.fused_smem_bytes(16, 16, 16) == 2 * 4 * (2 * 256 + 2 * 256)
    d = tat.DEFAULTS["mamba_scan_fused"]
    assert d["bdi"] == 0            # rows that spread the blocks evenly
    assert tker.fused_accepts(12, 16, 16) and tker.fused_accepts(100, 16, 32)
    assert not tker.fused_accepts(16, 16, 8)         # a chunk not built
    assert not tker.fused_accepts(256, 32, 16)       # over 512 threads
    assert not tker.fused_accepts(16, 33, 16)        # st over MAX_ST
    assert not tker.fused_accepts(0, 16, 32)         # 0 is the wrapper's
    # 132 SMs: Hymba-1.5B's training microbatch in 128 blocks of 100 rows,
    # Falcon-Mamba-7B's width in 128 of 64, a small shape in blocks of 4
    assert tker.balanced_rows(4, 3200, 16, 32, 132) == 100
    assert tker.balanced_rows(1, 8192, 16, 32, 132) == 64
    assert tker.balanced_rows(2, 50, 5, 32, 132) == 4
    for st_ in range(1, tker.MAX_ST + 1):
        for bs in tker.FUSED_BS_BUILT:
            for B, di in ((1, 1), (2, 50), (4, 3200), (64, 8192)):
                rows = tker.balanced_rows(B, di, st_, bs, 132)
                assert tker.fused_accepts(rows, st_, bs), (B, di, st_, bs)
