"""Parity of the port's model layers with the JAX reference, layer by layer.

The same numpy inputs and the reference's own params (drawn by its
``init_*`` functions, converted jax -> numpy -> torch) go through
``repro.models.layers`` and ``repro_torch.models.layers`` on the CPU.
Tolerances: 1e-5 in f32 for every layer but ``mamba_forward``, which
holds the port's sequential scan (K3's plain version on the CPU) against
the reference's chunked associative scan at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.layers import attention as jattn
from repro.models.layers import common as jcommon
from repro.models.layers import mamba as jmamba
from repro.models.layers import moe as jmoe

from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, to_tensor
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import transformer as ttransformer
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import common as tcommon
from repro_torch.models.layers import mamba as tmamba
from repro_torch.models.layers import moe as tmoe

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **changes):
    """The reference's and the port's smoke config of `arch`."""
    return (dataclasses.replace(jconfigs.get_smoke(arch), **changes),
            dataclasses.replace(tconfigs.get_smoke(arch), **changes))


def _params(jp):
    """The reference's params and the port's copy of them on the CPU."""
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(*shape, seed=0, scale=1.0):
    """A numpy f32 input as a jax array and a torch tensor."""
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return jnp.asarray(a), to_tensor(a)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ------------------------------------------------------------------ common
def test_rmsnorm():
    scale = np.random.default_rng(1).normal(size=(48,)).astype(np.float32)
    jx, tx = _x(3, 5, 48)
    _close(tcommon.rmsnorm({"scale": to_tensor(scale)}, tx, 1e-5),
           jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    pos = np.array([0, 1, 7, 100, 4095, 70000], np.int32)
    jcos, jsin = jcommon.rope_angles(jnp.asarray(pos), 32, theta)
    tcos, tsin = tcommon.rope_angles(torch.from_numpy(pos), 32, theta)
    _close(tcos, jcos)
    _close(tsin, jsin)
    jx, tx = _x(2, 6, 3, 32)
    _close(tcommon.apply_rope(tx, tcos, tsin),
           jcommon.apply_rope(jx, jcos, jsin))


def test_mlp():
    jcfg, _ = _cfgs("llama3.2-1b")
    jp, tp = _params(jcommon.init_mlp(jcfg, jax.random.key(3), 96))
    jx, tx = _x(2, 7, jcfg.d_model, seed=3)
    _close(tcommon.mlp(tp, tx), jcommon.mlp(jp, jx))


@pytest.mark.parametrize("tie", [True, False])
def test_unembed_masks_the_padded_vocab(tie):
    jcfg, tcfg = _cfgs("llama3.2-1b", vocab_size=500, tie_embeddings=tie)
    assert jcfg.vocab_padded == 512
    jp, tp = _params(jcommon.init_embedding(jcfg, jax.random.key(4)))
    jx, tx = _x(2, 3, jcfg.d_model, seed=4)
    got = tcommon.unembed(tcfg, tp, tx)
    assert got.dtype == torch.float32
    _close(got, jcommon.unembed(jcfg, jp, jx))
    assert bool((got[..., 500:] == -1e30).all())
    toks = np.array([[0, 5, 499]], np.int32)
    _close(tcommon.embed(tp, torch.from_numpy(toks)),
           jcommon.embed(jp, jnp.asarray(toks)))


def test_softmax_cross_entropy():
    jl, tl = _x(2, 5, 40, seed=5, scale=3.0)
    labels = np.random.default_rng(5).integers(0, 40, (2, 5)).astype(np.int32)
    mask = np.array([[1, 1, 0, 1, 1], [0, 1, 1, 1, 0]], np.float32)
    _close(tcommon.softmax_cross_entropy(tl, torch.from_numpy(labels),
                                         torch.from_numpy(mask)),
           jcommon.softmax_cross_entropy(jl, jnp.asarray(labels),
                                         jnp.asarray(mask)))


# --------------------------------------------------------------- attention
def _qkv(B, Sq, Sk, H, hd, seed):
    return [_x(B, S, H, hd, seed=seed + i, scale=sc)
            for i, (S, sc) in enumerate(((Sq, 0.5), (Sk, 0.5), (Sk, 1.0)))]


def _valid(Sk, n_pad):
    v = np.arange(Sk) >= n_pad
    return jnp.asarray(v), torch.from_numpy(v)


@pytest.mark.parametrize("causal,window,n_pad", [
    (True, 0, 0), (True, 5, 0), (False, 0, 3), (True, 6, 4)])
def test_sdpa(causal, window, n_pad):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 24, 24, 3, 8, seed=6)
    pos = np.arange(24, dtype=np.int32) - n_pad
    jval, tval = _valid(24, n_pad) if n_pad else (None, None)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    _close(tattn.sdpa(tq, tk, tv, tpos, tpos, causal=causal, window=window,
                      k_valid=tval),
           jattn.sdpa(jq, jk, jv, jpos, jpos, causal=causal, window=window,
                      k_valid=jval))


@pytest.mark.parametrize("causal,window,n_pad", [
    (True, 0, 0), (True, 10, 0), (False, 0, 5), (True, 12, 9)])
def test_chunked_sdpa(causal, window, n_pad):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 32, 32, 2, 8, seed=7)
    pos = np.arange(32, dtype=np.int32) - n_pad
    jval, tval = _valid(32, n_pad) if n_pad else (None, None)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    kw = dict(causal=causal, window=window, q_chunk=8, kv_chunk=16)
    got = tattn.chunked_sdpa(tq, tk, tv, tpos, tpos, k_valid=tval, **kw)
    _close(got, jattn.chunked_sdpa(jq, jk, jv, jpos, jpos, k_valid=jval,
                                   **kw))
    # and the one-block form agrees with the chunked one
    _close(got, jattn.sdpa(jq, jk, jv, jpos, jpos, causal=causal,
                           window=window, k_valid=jval))


def _gqa_cfgs(**changes):
    return _cfgs("llama3.2-1b", d_model=32, n_heads=4, n_kv_heads=2,
                 head_dim=8, **changes)


@pytest.mark.parametrize("S,window,n_pad", [
    (40, 0, 0), (40, 16, 0), (40, 0, 7), (3072, 2048, 100)])
def test_gqa_forward(S, window, n_pad):
    """S = 3072 takes the chunked path (above CHUNK_THRESHOLD)."""
    jcfg, tcfg = _gqa_cfgs()
    jp, tp = _params(jattn.init_gqa(jcfg, jax.random.key(8)))
    jx, tx = _x(1, S, jcfg.d_model, seed=8)
    pos = np.arange(S, dtype=np.int32) - n_pad
    jval, tval = _valid(S, n_pad) if n_pad else (None, None)
    jout, jcache = jattn.gqa_forward(jcfg, jp, jx, jnp.asarray(pos),
                                     window=window, k_valid=jval)
    tout, tcache = tattn.gqa_forward(tcfg, tp, tx, torch.from_numpy(pos),
                                     window=window, k_valid=tval)
    _close(tout, jout)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k])


def test_gqa_cross_attention():
    jcfg, tcfg = _gqa_cfgs()
    jp, tp = _params(jattn.init_gqa(jcfg, jax.random.key(9)))
    jx, tx = _x(2, 10, jcfg.d_model, seed=9)
    (jk, tk), (jv, tv) = [_x(2, 14, 2, 8, seed=s) for s in (10, 11)]
    pos = np.arange(10, dtype=np.int32)
    jout, _ = jattn.gqa_forward(jcfg, jp, jx, jnp.asarray(pos), causal=False,
                                kv_override=(jk, jv))
    tout, _ = tattn.gqa_forward(tcfg, tp, tx, torch.from_numpy(pos),
                                causal=False, kv_override=(tk, tv))
    _close(tout, jout)


@pytest.mark.parametrize("window,pos,start", [
    (0, [5, 17], None),            # linear cache
    (0, [9, 20], [3, 0]),          # left-padded rows
    (8, [5, 19], None),            # ring buffer, one row wrapped
    (8, [11, 30], [6, 2]),         # ring wrap with a start per row
    (8, [8, 16], [0, 9]),          # exactly one lap, start inside the ring
])
def test_gqa_decode(window, pos, start):
    jcfg, tcfg = _gqa_cfgs()
    jp, tp = _params(jattn.init_gqa(jcfg, jax.random.key(12)))
    Sc = window or 24
    jx, tx = _x(2, 1, jcfg.d_model, seed=12)
    (jk, tk), (jv, tv) = [_x(2, Sc, 2, 8, seed=s) for s in (13, 14)]
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.tensor(pos)
    js = None if start is None else jnp.asarray(start, jnp.int32)
    ts = None if start is None else torch.tensor(start)
    jout, jc = jattn.gqa_decode(jcfg, jp, jx, {"k": jk, "v": jv}, jpos,
                                window=window, start=js)
    tcache = {"k": tk, "v": tv}
    tout, tc = tattn.gqa_decode(tcfg, tp, tx, tcache, tpos, window=window,
                                start=ts)
    _close(tout, jout)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
        assert tc[k] is tcache[k]        # written in place


def test_gqa_decode_cross():
    jcfg, tcfg = _gqa_cfgs()
    jp, tp = _params(jattn.init_gqa(jcfg, jax.random.key(15)))
    jx, tx = _x(2, 1, jcfg.d_model, seed=15)
    (jk, tk), (jv, tv) = [_x(2, 12, 2, 8, seed=s) for s in (16, 17)]
    pos = jnp.asarray([3, 9], jnp.int32)
    jout, _ = jattn.gqa_decode(jcfg, jp, jx, {"k": jk, "v": jv}, pos,
                               cross=True)
    tout, tc = tattn.gqa_decode(tcfg, tp, tx, {"k": tk, "v": tv},
                                torch.tensor([3, 9]), cross=True)
    _close(tout, jout)
    assert tc["k"] is tk


def _mla_cfgs():
    return _cfgs("deepseek-v2-236b")


@pytest.mark.parametrize("n_pad", [0, 6])
def test_mla_forward(n_pad):
    jcfg, tcfg = _mla_cfgs()
    jp, tp = _params(jattn.init_mla(jcfg, jax.random.key(18)))
    jx, tx = _x(2, 20, jcfg.d_model, seed=18)
    pos = np.arange(20, dtype=np.int32) - n_pad
    jval, tval = _valid(20, n_pad) if n_pad else (None, None)
    jout, jc = jattn.mla_forward(jcfg, jp, jx, jnp.asarray(pos), k_valid=jval)
    tout, tc = tattn.mla_forward(tcfg, tp, tx, torch.from_numpy(pos),
                                 k_valid=tval)
    _close(tout, jout)
    for k in ("ckv", "k_rope"):
        _close(tc[k], jc[k])


@pytest.mark.parametrize("pos,start", [([4, 15], None), ([10, 15], [3, 0])])
def test_mla_decode(pos, start):
    jcfg, tcfg = _mla_cfgs()
    jp, tp = _params(jattn.init_mla(jcfg, jax.random.key(19)))
    jx, tx = _x(2, 1, jcfg.d_model, seed=19)
    (jckv, tckv), (jkr, tkr) = [_x(2, 16, n, seed=s) for n, s in
                                ((jcfg.kv_lora_rank, 20),
                                 (jcfg.qk_rope_dim, 21))]
    js = None if start is None else jnp.asarray(start, jnp.int32)
    ts = None if start is None else torch.tensor(start)
    jout, jc = jattn.mla_decode(jcfg, jp, jx, {"ckv": jckv, "k_rope": jkr},
                                jnp.asarray(pos, jnp.int32), start=js)
    tout, tc = tattn.mla_decode(tcfg, tp, tx, {"ckv": tckv, "k_rope": tkr},
                                torch.tensor(pos), start=ts)
    _close(tout, jout)
    for k in ("ckv", "k_rope"):
        _close(tc[k], jc[k])


# -------------------------------------------------------------------- MoE
@pytest.mark.parametrize("capacity,groups", [
    (16.0, 1),     # the smoke config: drop-free
    (1.0, 1),      # capacity 8 for ~16 rows an expert: rows dropped
    (1.0, 2),      # group-local dispatch with drops
])
def test_moe_forward(capacity, groups):
    """Routing over 8 logical experts padded to 16; top_i, the dispatch
    plan (dest, keep, order) equal; output 1e-5; aux equal."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", moe_capacity_factor=capacity)
    assert jcfg.moe_n_routed_padded == 16 > jcfg.moe_n_routed
    jp, tp = _params(jmoe.init_moe(jcfg, jax.random.key(22)))
    jx, tx = _x(2, 32, jcfg.d_model, seed=22)
    T, d = 64, jcfg.d_model
    jtp, jti, jaux = jmoe._route(jcfg, jp, jx.reshape(T, d))
    ttp, tti, taux = tmoe._route(tcfg, tp, tx.reshape(T, d))
    np.testing.assert_array_equal(tti.numpy(), np.asarray(jti))
    _close(ttp, jtp)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)

    tg, e = T // groups, jcfg.moe_n_routed_padded
    cap = int(-(-capacity * tg * jcfg.moe_top_k // e))   # as moe_forward
    cap = max(8, ((cap + 7) // 8) * 8)
    jplan = jmoe._dispatch_plan(jcfg, jtp, jti, groups, tg, cap, e)
    tplan = tmoe._dispatch_plan(tcfg, to_tensor(np.asarray(jtp)),
                                to_tensor(np.asarray(jti)), groups, tg, cap,
                                e)
    for name, got, want in zip(("dest", "keep", "sorted_tok"), tplan, jplan):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    dropped = int((~tplan[1]).sum())
    assert (dropped > 0) == (capacity < 16.0), dropped

    jout, jaux2 = jmoe.moe_forward(jcfg, jp, jx, groups=groups)
    tout, taux2 = tmoe.moe_forward(tcfg, tp, tx, groups=groups)
    _close(tout, jout)
    np.testing.assert_allclose(taux2.item(), float(jaux2), rtol=1e-6)


def test_topk_takes_the_first_of_tied_maxima():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    jv, ji = jmoe._topk_iterative(jnp.asarray(probs), 3)
    tv, ti = tmoe._topk_iterative(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32


def test_moe_expert_parallel_path_is_not_ported():
    """The expert-parallel combine is ported: ``ep_axis="model"`` on a
    1 x 1 gloo mesh takes it (all experts on the one rank) and equals
    the GSPMD combine bit for bit, forward and gradients, with capacity
    drops; without a mesh ``ep_axis`` names no axis and the GSPMD
    combine runs, as in the reference.  (The name is historical: it is
    kept so that the test's ID stays the same since the refusal it once
    asserted was removed.)"""
    from repro_torch.core import DeviceGrid
    from repro_torch.launch import spmd
    from repro_torch.sharding import parallel
    _, tcfg = _cfgs("qwen2-moe-a2.7b", moe_capacity_factor=1.0)
    p = tmoe.init_moe(tcfg, torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, tcfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    ctx = parallel.Ctx(spmd.local_mesh(DeviceGrid([torch.device("cpu")])),
                       ())
    calls = []
    real = tmoe._combine_ep
    tmoe._combine_ep = lambda *a: calls.append(1) or real(*a)
    try:
        def run(ep_axis, ctx):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in p.items() if k != "shared"}
            xi = x.detach().requires_grad_(True)
            out, aux = tmoe.moe_forward(tcfg, {**p, **leaves}, xi, groups=2,
                                        ep_axis=ep_axis, ctx=ctx)
            grads = torch.autograd.grad((out.square().sum() + aux),
                                        [xi, *leaves.values()])
            return out, aux, grads

        want = run(None, None)
        got = run("model", ctx)
        assert calls == [1]
        no_mesh = run("model", None)
        assert calls == [1]
    finally:
        tmoe._combine_ep = real
    for a, b, c in zip((want[0], want[1], *want[2]),
                       (got[0], got[1], *got[2]),
                       (no_mesh[0], no_mesh[1], *no_mesh[2])):
        assert torch.equal(a, b) and torch.equal(a, c)


# ------------------------------------------------------------------ Mamba
def _mamba(arch="hymba-1.5b", seed=23):
    jcfg, tcfg = _cfgs(arch)
    return jcfg, tcfg, *_params(jmamba.init_mamba(jcfg, jax.random.key(seed)))


@pytest.mark.parametrize("arch,S", [("hymba-1.5b", 512),
                                    ("falcon-mamba-7b", 512),
                                    ("hymba-1.5b", 40), ("hymba-1.5b", 3)])
def test_mamba_forward(arch, S):
    """S = 512 is two of the reference's scan chunks; S = 40 one short
    chunk; S = 3 exactly fills the conv cache."""
    jcfg, tcfg, jp, tp = _mamba(arch)
    jx, tx = _x(2, S, jcfg.d_model, seed=24)
    jout, jc = jmamba.mamba_forward(jcfg, jp, jx)
    tout, tc = tmamba.mamba_forward(tcfg, tp, tx)
    tol = dict(rtol=1e-4, atol=1e-4)
    _close(tout, jout, **tol)
    _close(tc["h"], jc["h"], **tol)
    _close(tc["conv"], jc["conv"], **tol)


def test_mamba_forward_keeps_the_scan_chunk_rule():
    _, tcfg, _, tp = _mamba()
    with pytest.raises(AssertionError):
        tmamba.mamba_forward(tcfg, tp, torch.zeros(1, 300, tcfg.d_model))


def test_mamba_forward_runs_its_scan_through_k3(monkeypatch):
    """One call of kernels.mamba_scan.ops.selective_scan (K3's fused
    mode) per layer, with its input contract: f32, contiguous, st <= 32;
    and no call of the (a, b) mode's ops.scan."""
    _, tcfg, _, tp = _mamba()
    calls = []
    real = scan_ops.selective_scan

    def counting(*ts, **kw):
        calls.append([t.dtype for t in ts]
                     + [all(t.is_contiguous() for t in ts)])
        return real(*ts, **kw)

    monkeypatch.setattr(scan_ops, "selective_scan", counting)
    monkeypatch.setattr(scan_ops, "scan", None)
    tmamba.mamba_forward(tcfg, tp, torch.randn(2, 256, tcfg.d_model))
    assert calls == [[torch.float32] * 6 + [True]]
    # and a whole model: one call per SSM layer
    calls.clear()
    params = ttransformer.init_params(tcfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    ttransformer.prefill(tcfg, params,
                         {"tokens": torch.zeros(1, 16, dtype=torch.int32)})
    assert len(calls) == tcfg.n_layers


@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b"])
def test_mamba_decode(arch):
    jcfg, tcfg, jp, tp = _mamba(arch, seed=25)
    jx, tx = _x(2, 1, jcfg.d_model, seed=25)
    (jconv, tconv), (jh, th) = (
        _x(2, jcfg.ssm_d_conv - 1, jcfg.ssm_d_inner, seed=26),
        _x(2, jcfg.ssm_d_inner, jcfg.ssm_d_state, seed=27, scale=0.1))
    jout, jc = jmamba.mamba_decode(jcfg, jp, jx, {"conv": jconv, "h": jh})
    tout, tc = tmamba.mamba_decode(tcfg, tp, tx, {"conv": tconv, "h": th})
    _close(tout, jout)
    for k in ("conv", "h"):
        _close(tc[k], jc[k])


@pytest.mark.parametrize("init", [tattn.init_gqa, tattn.init_mla,
                                  tmamba.init_mamba, tmoe.init_moe])
def test_inits_match_the_reference_tree(init):
    """Same keys, shapes and dtypes as the reference's init, with and
    without stacked-layer axes."""
    arch = {tattn.init_mla: "deepseek-v2-236b",
            tmoe.init_moe: "qwen2-moe-a2.7b"}.get(init, "hymba-1.5b")
    jcfg, tcfg = _cfgs(arch)
    jinit = getattr({tattn.init_gqa: jattn, tattn.init_mla: jattn,
                     tmamba.init_mamba: jmamba, tmoe.init_moe: jmoe}[init],
                    init.__name__)
    want = jinit(jcfg, jax.random.key(0))
    for lead in ((), (3,)):
        got = init(tcfg, torch.Generator().manual_seed(0), lead)
        assert sorted(got) == sorted(want)
        for k, v in jax.tree_util.tree_leaves_with_path(want):
            leaf = got
            for part in k:
                leaf = leaf[part.key]
            assert tuple(leaf.shape) == (*lead, *v.shape), k
            assert str(leaf.dtype).removeprefix("torch.") == str(v.dtype), k
