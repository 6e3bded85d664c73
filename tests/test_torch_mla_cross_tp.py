"""Head-parallel MLA and cross-attention on gloo ranks.

DeepSeek-V2 (MLA, expert-parallel MoE) and SeamlessM4T (cross-attention)
smoke configs (f32) on (data, model) meshes (1, 2) and (2, 2) through
``launch/spmd.py`` (one spawn a mesh, both archs inside it, every spawn
with its own timeout), their heads split over "model" as the reference's
plan places them:

* training: the loss and every ``full_tensor()`` gradient of the sharded
  step within 1e-4 of the reference's ``jax.value_and_grad(loss_fn)`` on
  one device, from the same converted params and batch (the reference's
  own ``init_params`` and ``TokenPipeline``): plain, with
  ``save_tp_out``, under sequence parallelism (``act_spec(sp=True)``)
  and under both;
* structure, on (1, 2) with the serving plan: ``_block_uses`` marks
  MLA's ``w_uq``, ``w_uk``, ``w_uv``, ``wo`` and cross-attention's
  ``wq``, ``wk``, ``wv``, ``wo`` SHARD; around one sharded prefill and
  one decode step (``roofline.collectives.CollectiveCounter``) no
  all-gather over "model" takes a weight's local shard as its input,
  and the all-gather bytes over "model" equal those of the activations
  alone, computed from the shapes: MLA's two latents a layer and token,
  and in decode, on the sequence-split latent cache, every head's
  absorbed query; none for Seamless, whose caches split by heads.

The sharded prefill and decode logits, caches and tokens are held
against the reference by ``tests/test_torch_serve_sharded.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import DeviceGrid
from repro_torch.launch import spmd
from repro_torch.models import transformer
from repro_torch.models.config import ShapeConfig
from repro_torch.roofline.collectives import CollectiveCounter, payload
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.sharding import Plan, parallel
from repro_torch.sharding.parallel import SHARD
from repro_torch.util import tree_leaves, tree_paths

CPU = torch.device("cpu")
RANK_TIMEOUT = 300.0
ARCHS = ("deepseek-v2-236b", "seamless-m4t-medium")
EP = {"deepseek-v2-236b": "model", "seamless-m4t-medium": None}
B, S = 4, 16                 # training batch
# serving: rows, prompt, slots, frames (widths that no weight shard has)
PB, PS, GROW, ENC = 3, 12, 24, 8
GROW_ODD = 25                # slots that "model" does not divide
VARIANTS = ((False, None), (False, "save_tp_out"), (True, None),
            (True, "save_tp_out"))
HEAD_WEIGHTS = {"attn": ("w_uq", "w_uk", "w_uv", "wo"),
                "cross": ("wq", "wk", "wv", "wo")}
TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
# the dry-run's serving cells, cut to smoke sizes (seq 128, batch 8)
DRYRUN_SHAPES = {"prefill": ShapeConfig("prefill_32k", 128, 8, "prefill"),
                 "decode": ShapeConfig("decode_32k", 128, 8, "decode")}
DRYRUN_CASES = [(arch, kind) for arch in ARCHS for kind in DRYRUN_SHAPES]


def _reference(arch, seed):
    """The reference's loss and gradients (``jax.value_and_grad(loss_fn)``
    on one device), and its params and batch converted for the port."""
    import jax
    from repro import configs as jconfigs
    from repro.data.pipeline import TokenPipeline as JPipeline
    from repro.models import transformer as jtransformer
    from repro_torch.convert import params_from_numpy, to_tensor
    jcfg = jconfigs.get_smoke(arch)
    jparams = jtransformer.init_params(jcfg, jax.random.key(seed))
    jbatch = JPipeline(jcfg, batch=B, seq=S, seed=seed).batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.loss_fn(jcfg, p, b)))(jparams, jbatch)
    want = (float(loss), {p: to_tensor(np.asarray(g)) for p, g in
                          tree_paths(jax.tree.map(np.asarray, grads))})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    batch = {k: to_tensor(np.asarray(v)) for k, v in jbatch.items()}
    return want, params, batch


def _serving_batch(arch):
    cfg = configs.get_smoke(arch)
    rng = np.random.default_rng(29)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PB, PS)).astype(np.int32))}
    if cfg.is_encoder_decoder:
        batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (PB, ENC, cfg.d_model)).astype(np.float32))
    return batch


# ------------------------------------------------------- on every rank
def _train(mesh, arch, params, batch):
    """For each VARIANTS entry: the loss, the full gradients by path and
    the shapes of the blocks' inputs (the residual stream)."""
    cfg = configs.get_smoke(arch)
    plan = Plan.for_mesh(mesh)
    placed = parallel.distribute_tree(params, plan.param_specs(params), mesh)
    leaves = tree_leaves(placed)
    for t in leaves:
        t.requires_grad_(True)
    shapes = set()
    real = transformer.block_forward

    def recorded(cfg_, seg, p, x, *a, **k):
        shapes.add(tuple(x.shape))
        return real(cfg_, seg, p, x, *a, **k)

    transformer.block_forward = recorded
    out = {}
    try:
        for sp, policy in VARIANTS:
            shapes.clear()
            loss = transformer.loss_fn(
                cfg, placed, batch, act_spec=plan.act_spec(sp=sp),
                moe_groups=plan.dp_size, moe_ep_axis=EP[arch],
                remat_policy=policy)
            grads = torch.autograd.grad(loss, leaves)
            out[(sp, policy)] = (float(loss.detach()), {
                p: g.full_tensor() for (p, _), g in zip(tree_paths(placed),
                                                        grads)},
                sorted(shapes))
    finally:
        transformer.block_forward = real
    return out


def _model_calls(counter, mesh):
    name = mesh.get_group("model").group_name
    return [c for c in counter.calls if c.group == name]


def _structure(mesh, arch, params):
    """On the serving plan: the uses of each decoder segment's attention
    and cross-attention weights, their per-layer local shapes, and the
    collectives over "model" of one prefill and one decode step."""
    cfg = configs.get_smoke(arch)
    plan = dataclasses.replace(Plan.for_mesh(mesh), serving=True)
    plain = params
    params = parallel.distribute_tree(params, plan.param_specs(params), mesh)
    batch = _serving_batch(arch)
    ctx = parallel.context(params, batch)
    uses, shapes = [], set()
    for seg, sp in zip(transformer.build_segments(cfg), params["segments"]):
        groups = transformer._block_groups(cfg, seg, ctx, EP[arch])
        u = transformer._block_uses(sp, groups, serving=True)
        uses.append({k: u[k] for k in HEAD_WEIGHTS if k in u})
    for t in tree_leaves(params):
        local = tuple(parallel.local(t).shape)
        shapes |= {local, local[1:]}       # stacked, and one layer's
    groups = plan.dp_size
    ep = EP[arch]
    with CollectiveCounter() as pre:
        caches, logits = make_prefill_step(cfg, moe_groups=groups,
                                           moe_ep_axis=ep)(params, batch)
    enc = ENC if cfg.is_encoder_decoder else 0
    caches = transformer.grow_caches(caches, transformer.init_caches(
        cfg, PB, GROW, enc, device="cpu", mesh=mesh))
    layouts = {k: parallel.model_dim(v, "model") for c in caches
               for k, v in c.items()}
    tok = torch.zeros((PB, 1), dtype=torch.int32)
    with CollectiveCounter() as dec:
        make_decode_step(cfg, moe_groups=groups, moe_ep_axis=ep)(
            params, caches, tok, torch.full((PB,), PS, dtype=torch.int32))
    # a cache of an odd slot count does not split over "model": every
    # rank holds it whole and attends with its own heads alone; held
    # against the one-device step on the plain params
    pos = torch.full((PB,), PS, dtype=torch.int32)
    odd = []
    for p, m in ((params, mesh), (plain, None)):
        caches, _ = make_prefill_step(cfg, moe_groups=groups,
                                      moe_ep_axis=ep)(p, batch)
        caches = transformer.grow_caches(caches, transformer.init_caches(
            cfg, PB, GROW_ODD, enc, device="cpu", mesh=m))
        odd.append(make_decode_step(cfg, moe_groups=groups, moe_ep_axis=ep)(
            p, caches, tok, pos)[1])
    return {"uses": uses, "shapes": shapes, "layouts": layouts,
            "prefill": _model_calls(pre, mesh),
            "decode": _model_calls(dec, mesh),
            "odd_layout": parallel.model_dim(caches[0].get("ckv"), "model"),
            "odd": (odd[0].full_tensor(), odd[1])}


def _mesh_run(mesh, cases, structure):
    out = {arch: _train(mesh, arch, *args) for arch, args in cases.items()}
    if structure:
        for arch, (params, _) in cases.items():
            out[("structure", arch)] = _structure(mesh, arch, params)
    return out


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def references():
    return {arch: _reference(arch, 31 + i) for i, arch in enumerate(ARCHS)}


@pytest.fixture(scope="module")
def runs(references):
    cases = {arch: (params, batch)
             for arch, (_, params, batch) in references.items()}
    return {(dp, tp): spmd.run(DeviceGrid([CPU] * (dp * tp), tp=tp),
                               _mesh_run, cases, (dp, tp) == (1, 2),
                               timeout=RANK_TIMEOUT)
            for dp, tp in ((1, 2), (2, 2))}


def _max_rel(got, want):
    return max(float((got[p].float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-12)
               for p, w in want.items())


# ------------------------------------------------------------ the tests
@pytest.mark.parametrize("sp,policy", VARIANTS,
                         ids=["plain", "save_tp_out", "sp", "sp-save_tp_out"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_training_matches_the_reference(references, runs, arch, mesh, sp,
                                        policy):
    want = references[arch][0]
    loss, grads, shapes = runs[mesh][arch][(sp, policy)]
    # the residual stream: this rank's batch rows, and its chunk of the
    # sequence under sequence parallelism
    dp, tp = mesh
    assert shapes == [(B // dp, S // tp if sp else S,
                       configs.get_smoke(arch).d_model)]
    err = _max_rel(grads, want[1])
    print(arch, mesh, sp, policy, "loss", loss, "vs", want[0],
          "max rel grad err", err)
    assert loss == pytest.approx(want[0], rel=TOL)
    assert set(grads) == set(want[1])
    assert err <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_block_uses_shard_the_head_weights(runs, arch):
    uses = runs[(1, 2)][("structure", arch)]["uses"]
    key = "attn" if arch == "deepseek-v2-236b" else "cross"
    seen = 0
    for seg in uses:
        if key in seg:
            seen += 1
            for name in HEAD_WEIGHTS[key]:
                assert seg[key][name] == SHARD, (arch, key, name)
    assert seen == len(uses)


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_no_weight_shard_is_gathered_over_model(runs, arch, step):
    rec = runs[(1, 2)][("structure", arch)]
    # DTensor gathers a shard as it lies (its local shape is the input)
    gathers = [c for c in rec[step] if c.kind == "all-gather"]
    hit = [c.shape for c in gathers if c.shape in rec["shapes"]]
    assert not hit, f"{arch} {step}: weight shards gathered {hit}"


def _activation_gather_bytes(cfg, rows, tokens, seq_split, g=2):
    """Per-device all-gather bytes over "model" (of size `g`) that the
    activations alone account for, f32, for `rows` rows of `tokens`
    tokens a rank: a layer's q and kv latents (tokens x (q_lora +
    kv_lora + rope) a row) and, in decode (`seq_split`: on a
    sequence-split latent cache), every head's absorbed query (h x
    (kv_lora + rope) a row)."""
    if not cfg.use_mla:
        return 0.0
    lat = cfg.q_lora_rank + cfg.kv_lora_rank + cfg.qk_rope_dim
    per_layer = rows * tokens * lat
    if seq_split:
        per_layer += rows * cfg.n_heads * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    return payload("all-gather", 4 * cfg.n_layers * per_layer, g)


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_all_gathers_are_the_activations(runs, arch, step):
    rec = runs[(1, 2)][("structure", arch)]
    got = sum(payload(c.kind, c.nbytes, c.g) for c in rec[step]
              if c.kind == "all-gather")
    decode = step == "decode"
    seq_split = decode and rec["layouts"].get("ckv") == 2
    want = _activation_gather_bytes(configs.get_smoke(arch), PB,
                                    1 if decode else PS, seq_split)
    assert got == want, (arch, step, got, want)
    if arch == "deepseek-v2-236b" and decode:
        assert seq_split                      # the latent cache on "seq"



@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_an_unsplit_cache_matches_one_device(runs, arch):
    rec = runs[(1, 2)][("structure", arch)]
    if arch == "deepseek-v2-236b":
        assert rec["odd_layout"] is None      # the latent cache whole
    got, want = rec["odd"]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale, arch

def test_dryrun_serving_cells_gather_only_activations_over_model():
    """The dry-run's serving cells on a fake (2, 2) group (a subprocess:
    a fake group must not leak): ``collectives_by_axis`` splits
    ``collectives`` by axis, and over "model" the all-gathers are the
    activations' bytes alone (bf16 widths are f32 here: smoke configs)."""
    out = subprocess.run([sys.executable, __file__, "dryrun"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    recs = json.loads(out.stdout.strip().splitlines()[-1])
    for (arch, kind), rec in zip(DRYRUN_CASES, recs):
        by_axis = rec["collectives_by_axis"]
        for kind_ in rec["collectives"]:
            assert rec["collectives"][kind_] == pytest.approx(
                sum(v[kind_] for v in by_axis.values())), (arch, kind, kind_)
        shape = DRYRUN_SHAPES[kind]
        rows = shape.global_batch // 2                  # over "data"
        want = _activation_gather_bytes(
            configs.get_smoke(arch), rows,
            shape.seq_len if kind == "prefill" else 1, kind == "decode")
        assert by_axis["model"]["all-gather"] == want, (arch, kind)
        assert rec["kernel_launches"] == {k: 0 for k in
                                          rec["kernel_launches"]}


def test_a_depth_cut_keeps_the_whole_models_serving_plan():
    """``build_cell(plan_cfg=)`` (the dry-run's ``layers``): DeepSeek-V2's
    TP shard on (16, 16) is over the 10 GB rule, so its serving cells
    keep FSDP; a cut to 2 layers would drop it alone, and keeps it with
    the whole model's size."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import SHAPES
    full = configs.get("deepseek-v2-236b")
    cut = dataclasses.replace(full, n_layers=2)
    plan = Plan.for_mesh(make_production_mesh(multi_pod=False))
    for name in ("decode_32k", "prefill_32k"):
        whole = dryrun.build_cell(full, SHAPES[name], plan).plan
        kept = dryrun.build_cell(cut, SHAPES[name], plan,
                                 plan_cfg=full).plan
        alone = dryrun.build_cell(cut, SHAPES[name], plan).plan
        assert not whole.serving and kept == whole, name
        assert alone.serving, name


def _dryrun_cells():
    from repro_torch.launch import dryrun
    return [dryrun.run_cell(arch, kind + "_32k", False, verbose=False,
                            device="cpu", cfg=configs.get_smoke(arch),
                            mesh_axes={"data": 2, "model": 2},
                            shape=DRYRUN_SHAPES[kind])
            for arch, kind in DRYRUN_CASES]


if __name__ == "__main__":
    if sys.argv[1:] == ["dryrun"]:
        print(json.dumps(_dryrun_cells()))
