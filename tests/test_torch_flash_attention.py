"""Parity of the port's flash-attention wrapper with the JAX reference.

The same numpy inputs (``np.random.default_rng``) go through ``repro``
and ``repro_torch``.  On the CPU the port's wrapper runs its plain
version; the reference runs its jnp oracle and its Pallas kernel in
interpret mode.  Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-4 for f32, 5e-2 for bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref

from repro_torch import convert
from repro_torch.kernels import autotune as tat
from repro_torch.kernels.flash_attention import flash_attention as tker
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref


def _inputs(B, S_q, H, hd, dtype, seed, S_k=None):
    """Reference arrays and the port's tensors holding the same values."""
    rng = np.random.default_rng(seed)
    S_k = S_k or S_q
    arrays = [rng.normal(size=(B, S, H, hd)).astype(np.float32) * sc
              for S, sc in ((S_q, 0.3), (S_k, 0.3), (S_k, 1.0))]
    js = [jnp.asarray(a, dtype) for a in arrays]
    return js, [convert.to_tensor(np.asarray(j)) for j in js]


def _close(out, exp, tol):
    np.testing.assert_allclose(convert.to_numpy(out).astype(np.float32),
                               np.asarray(exp, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,S,H,hd", [(1, 128, 2, 32), (2, 128, 2, 64),
                                      (1, 128, 1, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0), (False, 32)])
def test_attention_matches_reference_and_pallas(B, S, H, hd, causal,
                                                window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, H, hd, jnp.float32,
                                         seed=S + hd)
    out = tops.attention(tq, tk, tv, causal=causal, window=window)
    assert out.shape == tq.shape and out.dtype == torch.float32
    _close(out, jref.attention(jq, jk, jv, causal=causal, window=window),
           2e-4)
    _close(out, jops.attention(jq, jk, jv, causal=causal, window=window,
                               bq=64, bk=64), 2e-4)


@pytest.mark.parametrize("S,window", [(100, 0), (97, 16), (211, 64)])
def test_attention_sequence_no_block_divides(S, window):
    """S = 100, 97 (prime) and 211 (prime): the reference snaps its
    blocks to divisors; the port's kernel masks the ragged edge."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, S, 2, 32, jnp.float32, seed=S)
    out = tops.attention(tq, tk, tv, window=window)
    _close(out, jref.attention(jq, jk, jv, window=window), 2e-4)
    _close(out, jops.attention(jq, jk, jv, window=window), 2e-4)


def test_attention_cross_lengths():
    """S_q != S_k, bidirectional: positions start at 0 on both sides."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 64, 2, 32, jnp.float32, seed=3,
                                         S_k=128)
    for causal in (True, False):
        out = tops.attention(tq, tk, tv, causal=causal)
        _close(out, jref.attention(jq, jk, jv, causal=causal), 2e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_attention_bf16(causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 128, 2, 64, jnp.bfloat16,
                                         seed=0)
    out = tops.attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    _close(out, jref.attention(jq, jk, jv, causal=causal, window=window),
           5e-2)
    _close(out, jops.attention(jq, jk, jv, causal=causal, window=window,
                               bq=64, bk=64), 5e-2)


def test_attention_plain_version_is_the_cpu_path():
    _, (tq, tk, tv) = _inputs(1, 64, 2, 32, jnp.float32, seed=5)
    assert torch.equal(tops.attention(tq, tk, tv, window=8, bq=32, bk=16),
                       tref.attention(tq, tk, tv, window=8))


def test_attention_refuses_devices_it_has_no_kernel_for():
    q = torch.empty((1, 8, 1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.attention(q, q, q)


def test_smem_formula_and_defaults_fit_every_head_dim():
    # padded query tile + K and V tiles (bk rounded up to 8 keys), f32
    assert tker.smem_bytes(128, 32, 64) == 4 * (128 * 68 + 2 * 32 * 64)
    assert tker.smem_bytes(64, 20, 32) == 4 * (64 * 36 + 2 * 24 * 32)
    d = tat.DEFAULTS["flash_attention"]
    for hd in tker.HEAD_DIMS:
        assert tker.smem_bytes(d["bq"], d["bk"], hd) <= tker.SMEM_MAX
    assert d["bq"] <= tker.MAX_THREADS
