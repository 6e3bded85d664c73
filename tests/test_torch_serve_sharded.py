"""Sharded serving on gloo ranks against the reference's one-device steps.

The port's ``make_prefill_step`` / ``make_decode_step(sample=True)`` on
DTensor params under the weight-stationary serving plan
(``Plan(serving=True)``), on (data, model) meshes (1, 2) and (2, 2) of
CPU ranks through ``launch/spmd.py`` (one spawn a mesh, every arch
inside it, each spawn with its own timeout), against the reference's
jitted one-device ``prefill`` / ``decode_step`` on the same converted
params (f32 smoke configs):

* a 40-token prompt for 2 rows (past Hymba's 32-token window), its
  caches grown to 48 slots (``grow_caches`` into ``init_caches(mesh=)``),
  8 greedy steps: the prefill's and every step's logits and every
  cache's ``full_tensor()`` within 1e-4 of the largest reference value,
  the greedy tokens equal;
* the five configs cover each layout: Llama (kv heads over "model"),
  Hymba (one kv head: the cache split on the sequence, flash-decode
  style, a window-32 ring buffer and Mamba's ``d_inner`` shard through
  K3's plain version), Qwen2-MoE and DeepSeek-V2 (expert-parallel MoE;
  DeepSeek's MLA latent caches split on the sequence), Seamless
  (cross-attention caches); Hymba runs once more as a left-padded
  (bucketed) prompt decoding with ``start``;
* each rank's local block of each cache has the shape the reference's
  ``Plan.cache_specs`` gives a shard;
* the expert-parallel combine equals the GSPMD one bit for bit in
  decode (the same caches, the same tokens).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.serve import step as jstep
from repro.sharding import Plan as JPlan

from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import DeviceGrid
from repro_torch.launch import spmd
from repro_torch.models import transformer
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.sharding import Plan, parallel

CPU = torch.device("cpu")
RANK_TIMEOUT = 240.0
ARCHS = ("llama3.2-1b", "hymba-1.5b", "qwen2-moe-a2.7b", "deepseek-v2-236b",
         "seamless-m4t-medium")
B, S, GROW, STEPS, ENC, PAD = 2, 40, 48, 8, 8, 3
MOE = ("qwen2-moe-a2.7b", "deepseek-v2-236b")
CASES = [(a, False) for a in ARCHS] + [("hymba-1.5b", True)]


def _inputs(arch: str, bucketed: bool):
    cfg = jconfigs.get_smoke(arch)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = rng.standard_normal(
            (B, ENC, cfg.d_model)).astype(np.float32)
    start = None
    if bucketed:
        tokens[:, :PAD] = 0
        batch["positions"] = (np.arange(S) - PAD).astype(np.int32)
        batch["pad_mask"] = np.arange(S) >= PAD
        start = np.full((B,), PAD, np.int32)
    return batch, start


def _reference(arch: str, bucketed: bool):
    """The reference's jitted one-device prefill, grown caches and greedy
    decode; every array as numpy."""
    jcfg = jconfigs.get_smoke(arch)
    params = jtransformer.init_params(jcfg, jax.random.key(5))
    batch, start = _inputs(arch, bucketed)
    caches, logits = jax.jit(jstep.make_prefill_step(jcfg))(
        params, jax.tree.map(jnp.asarray, batch))
    out = {"prefill": np.asarray(logits),
           "prefill_caches": jax.tree.map(np.asarray, caches)}
    enc = ENC if jcfg.is_encoder_decoder else 0
    grown = jax.eval_shape(lambda: jtransformer.init_caches(jcfg, B, GROW,
                                                            enc))
    caches = jax.tree.map(lambda buf, spec: jnp.pad(
        buf, [(0, t - s) for s, t in zip(buf.shape, spec.shape)]),
        caches, grown)
    decode = jax.jit(jstep.make_decode_step(jcfg, sample=True))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    jstart = None if start is None else jnp.asarray(start)
    out["logits"], out["tokens"] = [], []
    for t in range(STEPS):
        caches, lg, tok = decode(params, caches, tok,
                                 jnp.full((B,), S + t, jnp.int32), jstart)
        out["logits"].append(np.asarray(lg))
        out["tokens"].append(np.asarray(tok))
    out["caches"] = jax.tree.map(np.asarray, caches)
    out["params"] = jax.tree.map(np.asarray, params)
    return out


def _shard_shapes(arch: str, mesh_axes, enc: int):
    """The reference ``Plan.cache_specs``' shard shape of every grown
    cache leaf."""
    jcfg = jconfigs.get_smoke(arch)
    plan = JPlan(mesh_axes=dict(mesh_axes), dp_axes=("data",))
    shapes = jax.eval_shape(lambda: jtransformer.init_caches(jcfg, B, GROW,
                                                             enc))
    specs = plan.cache_specs(jcfg, shapes)
    out = []
    for seg, sspec in zip(shapes, specs):
        d = {}
        for k, leaf in seg.items():
            shape = list(leaf.shape)
            for i, ax in enumerate(sspec[k]):
                for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                    shape[i] //= mesh_axes[a]
            d[k] = tuple(shape)
        out.append(d)
    return out


# ------------------------------------------------------- on every rank
def _full(t):
    return t.full_tensor() if isinstance(t, parallel.DTensor) else t


def _serve(mesh, arch, params_np, batch_np, start_np, ep):
    """One arch's prompt, grow and greedy decode on `mesh`; every result
    gathered whole (a collective: every rank calls it)."""
    import torch.distributed as dist
    cfg = configs.get_smoke(arch)
    plan = dataclasses.replace(Plan.for_mesh(mesh), serving=True)
    params = params_from_numpy(params_np, "cpu")
    params = parallel.distribute_tree(params, plan.param_specs(params), mesh)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch_np.items()}
    start = None if start_np is None else torch.from_numpy(start_np)
    groups = mesh.size(0)
    prefill = make_prefill_step(cfg, moe_groups=groups, moe_ep_axis=ep)
    decode = make_decode_step(cfg, sample=True, moe_groups=groups,
                              moe_ep_axis=ep)
    caches, logits = prefill(params, batch)
    out = {"prefill": _full(logits),
           "prefill_caches": [{k: _full(v) for k, v in c.items()}
                              for c in caches]}
    enc = batch["frame_embeds"].shape[1] if "frame_embeds" in batch else 0
    caches = transformer.grow_caches(caches, transformer.init_caches(
        cfg, B, GROW, enc, device="cpu", mesh=mesh))
    local = [{k: tuple(parallel.local(v).shape) for k, v in c.items()}
             for c in caches]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    out["local_shapes"] = every
    tok = torch.argmax(out["prefill"][:, -1], -1).to(torch.int32)[:, None]
    out["logits"], out["tokens"] = [], []
    for t in range(STEPS):
        caches, lg, tok = decode(params, caches, tok,
                                 torch.full((B,), S + t, dtype=torch.int32),
                                 start)
        assert isinstance(tok, parallel.DTensor)
        out["logits"].append(_full(lg))
        out["tokens"].append(_full(tok))
    out["caches"] = [{k: _full(v) for k, v in c.items()} for c in caches]
    if ep is not None:
        out["ep_vs_gspmd"] = _ep_vs_gspmd(cfg, params, caches, out, mesh)
    return out


def _ep_vs_gspmd(cfg, params, caches, out, mesh):
    """Teacher-forced decode from the same caches and tokens with the
    expert-parallel combine and with the GSPMD one: every logit equal."""
    def run(ep):
        cs = [{k: parallel.DTensor.from_local(
                   parallel.local(v).clone(), mesh, v.placements,
                   shape=v.shape, stride=v.stride())
               for k, v in c.items()} for c in caches]
        step = make_decode_step(cfg, moe_groups=mesh.size(0), moe_ep_axis=ep)
        return [_full(step(params, cs, tok, torch.full((B,), S + t,
                                                       dtype=torch.int32))[1])
                for t, tok in enumerate(out["tokens"][:3])]
    return [torch.equal(a, b) for a, b in zip(run("model"), run(None))]


def _all_cases(mesh, cases):
    return {key: _serve(mesh, *args) for key, args in cases.items()}


# ------------------------------------------------------------ the test
@pytest.fixture(scope="module")
def references():
    return {(arch, bucketed): _reference(arch, bucketed)
            for arch, bucketed in CASES}


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=what)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_sharded_serving_matches_the_reference(references, dp, tp):
    cases = {}
    for (arch, bucketed), ref in references.items():
        batch, start = _inputs(arch, bucketed)
        ep = "model" if arch in MOE else None
        cases[(arch, bucketed)] = (arch, ref["params"], batch, start, ep)
    got = spmd.run(DeviceGrid([CPU] * (dp * tp), tp=tp), _all_cases, cases,
                   timeout=RANK_TIMEOUT)
    axes = {"data": dp, "model": tp}
    for (arch, bucketed), ref in references.items():
        g = got[(arch, bucketed)]
        tag = f"{arch}{' bucketed' if bucketed else ''} on {dp}x{tp}"
        _close(g["prefill"], ref["prefill"], f"{tag}: prefill logits")
        for j, (gc, wc) in enumerate(zip(g["prefill_caches"],
                                         ref["prefill_caches"])):
            assert sorted(gc) == sorted(wc)
            for k in wc:
                _close(gc[k], wc[k], f"{tag}: prefill cache {j}/{k}")
        for t in range(STEPS):
            np.testing.assert_array_equal(g["tokens"][t].numpy(),
                                          ref["tokens"][t],
                                          err_msg=f"{tag}: step {t}")
            _close(g["logits"][t], ref["logits"][t], f"{tag}: step {t}")
        for j, (gc, wc) in enumerate(zip(g["caches"], ref["caches"])):
            for k in wc:
                _close(gc[k], wc[k], f"{tag}: cache {j}/{k}")
        enc = ENC if configs.get_smoke(arch).is_encoder_decoder else 0
        want = _shard_shapes(arch, axes, enc)
        for rank, shapes in enumerate(g["local_shapes"]):
            assert shapes == want, (tag, rank)
        if arch in MOE:
            assert g["ep_vs_gspmd"] and all(g["ep_vs_gspmd"]), tag
