"""The port's serving steps and batch specs against the JAX reference.

* ``make_prefill_step`` / ``make_decode_step(sample=True)``: the greedy
  tokens equal the reference's steps' (jitted, as its engine runs them)
  and the logits agree at 1e-4, on the smoke configs.
* A left-padded (bucketed) prompt prefills and decodes bit for bit like
  its unpadded form inside the port, with the pad mask, pad-relative
  positions and the per-row ``start`` (the property the reference's
  ``tests/test_serving_engine.py`` holds through its engine).
* ``input_specs`` / ``cache_specs`` give the reference's shapes and
  dtypes at full width, and the config copy counts the same parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import batches as jbatches
from repro.models import transformer as jtransformer
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import shape_applicable as jshape_applicable
from repro.serve import step as jstep

from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, to_tensor
from repro_torch.data import batches as tbatches
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.serve import make_decode_step, make_prefill_step

ARCHS = jconfigs.names()


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_counts_and_shapes(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.n_active_params() == jcfg.n_active_params()
    assert tcfg.param_dtype == getattr(torch, jcfg.dtype)
    assert sorted(SHAPES) == sorted(JSHAPES)
    for name in SHAPES:
        assert shape_applicable(tcfg, SHAPES[name]) == \
            jshape_applicable(jcfg, JSHAPES[name])
    assert tconfigs.get_smoke(arch) == tconfigs.SMOKE_REGISTRY[arch]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, shape):
    want = jbatches.input_specs(jconfigs.get(arch), JSHAPES[shape])
    got = tbatches.input_specs(tconfigs.get(arch), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == want[k].shape, k
        assert _dtype_name(v.dtype) == str(want[k].dtype), k


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch):
    want = jbatches.cache_specs(jconfigs.get(arch), 2, 4096)
    got = tbatches.cache_specs(tconfigs.get(arch), 2, 4096)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].device.type == "meta"
            assert tuple(g[k].shape) == w[k].shape, k
            assert _dtype_name(g[k].dtype) == str(w[k].dtype), k


def _pair(arch, seed=3):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jparams = jtransformer.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hymba-1.5b",
                                  "falcon-mamba-7b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-236b"])
def test_greedy_tokens_match_the_reference(arch):
    """Prefill 16 prompt tokens for 2 rows, then 6 greedy decode steps."""
    jcfg, tcfg, jparams, params = _pair(arch)
    B, S, steps, max_seq = 2, 16, 6, 32
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S))
    jcaches, jlogits = jax.jit(jstep.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    grown = jax.eval_shape(lambda: jtransformer.init_caches(jcfg, B, max_seq))
    jcaches = jax.tree.map(lambda buf, spec: jnp.pad(
        buf, [(0, t - s) for s, t in zip(buf.shape, spec.shape)]),
        jcaches, grown)
    jdecode = jax.jit(jstep.make_decode_step(jcfg, sample=True))

    prefill = make_prefill_step(tcfg)
    decode = make_decode_step(tcfg, sample=True)
    caches, logits = prefill(params, {"tokens": torch.from_numpy(toks)})
    assert logits.is_inference()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    caches = ttransformer.grow_caches(caches, ttransformer.init_caches(
        tcfg, B, max_seq, device="cpu"))
    jtok = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    tok = to_tensor(np.asarray(jtok))
    for t in range(steps):
        pos = S + t
        jcaches, jlg, jtok = jdecode(jparams, jcaches, jtok,
                                     jnp.full((B,), pos, jnp.int32))
        caches, lg, tok = decode(params, caches, tok,
                                 torch.full((B,), pos, dtype=torch.int32))
        assert tok.dtype == torch.int32 and tuple(tok.shape) == (B, 1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {t}")
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-67b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-236b"])
def test_bucketed_prefill_decodes_bitwise_like_unpadded(arch):
    """Left-pad each prompt to a bucket of 16 (pad mask, pad-relative
    positions, ``start`` in decode): every logit of the prefill and of 8
    greedy decode steps equals the unpadded run's bit for bit.  (Archs
    with Mamba layers are left out: the scan has no pad mask, in the
    reference too.)"""
    _, cfg, _, params = _pair(arch, seed=0)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg, sample=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 9, 12)]

    def serve(prompt, bucket):
        n = len(prompt)
        pad = bucket - n
        toks = torch.zeros((1, bucket), dtype=torch.int32)
        toks[0, pad:] = torch.from_numpy(prompt)
        caches, logits = prefill(params, {
            "tokens": toks, "positions": torch.arange(bucket) - pad,
            "pad_mask": torch.arange(bucket) >= pad})
        caches = ttransformer.grow_caches(
            caches, ttransformer.init_caches(cfg, 1, 64, device="cpu"))
        outs = [logits]
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        for t in range(8):
            caches, logits, tok = decode(params, caches, tok,
                                         torch.tensor([bucket + t]),
                                         torch.tensor([pad]))
            outs.append(logits)
        return outs

    for prompt in prompts:
        padded, exact = serve(prompt, 16), serve(prompt, len(prompt))
        for i, (a, b) in enumerate(zip(padded, exact)):
            assert torch.equal(a, b), (len(prompt), i,
                                       (a - b).abs().max().item())
