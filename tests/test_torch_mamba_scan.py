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
