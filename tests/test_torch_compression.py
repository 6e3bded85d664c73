"""Parity of the port's error-feedback int8 quantizer with the JAX
reference: the two ``ef_quantize`` residual cases of
tests/test_compression.py, run on both packages from the same numpy
inputs.  The int8 payloads must be equal, the scales and residuals
equal to f32 rounding."""
import jax.numpy as jnp
import numpy as np
import torch

from repro.optim import compression as jcomp
from repro_torch.optim import compression as tcomp

TOL = 1e-6


def test_ef_quantize_residual_is_exact_remainder():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(256,)).astype(np.float32)
    jq, js, jr = jcomp.ef_quantize(jnp.asarray(x), jnp.zeros(256))
    tq, ts, tr = tcomp.ef_quantize(torch.from_numpy(x), torch.zeros(256))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=TOL)
    # the residual is what the wire dropped, in each package
    np.testing.assert_allclose(
        tr.numpy(), (torch.from_numpy(x)
                     - tcomp.dequantize_int8(tq, ts)).numpy(), atol=TOL)
    np.testing.assert_allclose(
        np.asarray(jr), np.asarray(jnp.asarray(x)
                                   - jcomp.dequantize_int8(jq, js)),
        atol=TOL)


def test_ef_quantize_residual_carries_over():
    x = np.asarray([127.0, 0.3], np.float32)   # scale 1.0; 0.3 < step / 2

    def run(comp, asarray, host):
        xs = asarray(x)
        r = xs * 0
        sent, qs = np.zeros(2, np.float64), []
        for _ in range(4):                     # 4 * 0.3 = 1.2 > one step
            q, scale, r = comp.ef_quantize(xs, r)
            qs.append(host(q).tolist())
            sent += host(comp.dequantize_int8(q, scale)).astype(np.float64)
        return qs, sent, float(scale)

    jqs, jsent, jscale = run(jcomp, jnp.asarray, np.asarray)
    tqs, tsent, tscale = run(tcomp, torch.from_numpy, lambda t: t.numpy())
    assert tqs == jqs                          # the same int8 payloads
    np.testing.assert_allclose(tsent, jsent, atol=TOL)
    for sent, scale in ((jsent, jscale), (tsent, tscale)):
        np.testing.assert_allclose(sent, 4 * x.astype(np.float64),
                                   atol=scale + 1e-6)
        assert sent[1] > 0.0                   # the tiny coordinate sent
