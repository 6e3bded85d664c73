"""Production-size dry-run of one (arch x shape x mesh) cell, with no cards.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for a 256- or 512-chip mesh; the port traces it:

  * a ``"fake"`` process group of 256 or 512 ranks over ``FakeStore``
    (this process is rank 0; no collective moves a byte) and a
    ``DeviceMesh`` of (16, 16) or (2, 16, 16) with the production axis
    names, on the fake tensors' device type (a DTensor moves its local
    tensor to its mesh's device type).  On ``cuda`` the mesh selects
    card ``rank % cards``, card 0 for this rank 0: no other card is
    asked for, so one card (or any) is enough;
  * under ``FakeTensorMode`` (no storage) on fake ``--device`` tensors:
    the plan's DTensor state (params and both AdamW moments, the train
    cells) or params (the serving cells), and one step:
      - train: the sharded train step (``train.make_train_step``), every
        microbatch, forward, remat recompute and backward, and AdamW;
      - prefill and decode: the port serves on one device, so each rank
        gathers the weights and runs ``serve.step``'s prefill or decode
        step on its batch rows (its work is replicated over "model");
  * while it runs, ``FlopCounterMode`` (FLOPs per device), the
    collective counter (:mod:`repro_torch.roofline.collectives`) and
    ``MemTracker`` (peak bytes per device) watch it.  The kernels meet
    their fake-tensor shape rules: nothing launches, nothing is counted.

The record keeps the reference's keys, so readers of its JSON take the
port's:
  * ``memory``: ``MemTracker``'s per-device peak of live tensor storage
    during the step, the state and the batch included, in place of
    XLA:CPU's ``memory_analysis()``.  ``argument_bytes`` is what the
    step was handed (state or params, batch), ``temp_bytes`` the rest of
    the peak; the step updates its state in place, so ``output_bytes``
    and ``alias_bytes`` are 0.
  * ``cost_analysis``: ``flops_per_device`` from ``FlopCounterMode``
    (matmuls, attention and the scan's registered formula; no
    elementwise op), ``bytes_per_device`` None (nothing counts it).
  * ``collectives``: per-device payload bytes of every collective the
    step issued, with the reference's conventions.
  * ``analytic``, ``params_bytes_per_device``, ``state_bytes_per_device``,
    ``analytic_peak_bytes_per_device``, ``n_microbatches``,
    ``fits_hbm_analytic``, ``terms``: the reference's arithmetic, the
    H100's ``HW`` and 80 GB of HBM.
  * ``trace_s`` in place of ``lower_s`` and ``compile_s``, and
    ``torch_version``.

CLI (the reference's, plus ``--device`` for the fake tensors)::

    python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape train_4k \\
        --mesh single --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.core.resource_manager import HBM_BYTES_PER_CHIP
from repro_torch.data.batches import DEFAULT_ENC_LEN, batch_shapes, _dtype_of
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.config import (SHAPES, ModelConfig, ShapeConfig,
                                       shape_applicable)
from repro_torch.roofline import analytic
from repro_torch.roofline.collectives import CollectiveCounter
from repro_torch.roofline.terms import roofline_terms
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.sharding import Plan, Spec, parallel
from repro_torch.train.step import (make_train_state, make_train_step,
                                    microbatch_count)
from repro_torch.util import tree_leaves, tree_map

HBM_PER_CHIP = HBM_BYTES_PER_CHIP   # one H100

# Per-arch memory configuration for the train cells, the reference's
# entries: the largest archs take bf16 optimizer moments and bf16
# gradient accumulation; "pure_dp_single" runs the small attention-dense
# archs as pure data parallelism on the single-pod mesh (batch over
# data x model, no TP activation sums, weights gathered per layer).
TRAIN_MEMORY_OVERRIDES: Dict[str, Dict[str, Any]] = {
    # multi-pod doubles dp, so the local batch halves and 8 microbatches
    # suffice, halving the FSDP expert-weight streaming
    "deepseek-v2-236b": {"n_microbatches": 16, "n_microbatches_multi": 8,
                         "moment_dtype": torch.bfloat16,
                         "accum_dtype": torch.bfloat16},
    "deepseek-67b": {"n_microbatches": 16, "accum_dtype": torch.bfloat16,
                     "pure_dp_single": True},
    "llama3.2-1b": {"pure_dp_single": True},
    "internlm2-1.8b": {"pure_dp_single": True},
    "internvl2-2b": {"pure_dp_single": True},
    "yi-6b": {"pure_dp_single": True},
    "hymba-1.5b": {"pure_dp_single": True},
    "seamless-m4t-medium": {"pure_dp_single": True},
}


def _sharded_bytes(tree: Any, specs: Any, mesh_axes: Dict[str, int]
                   ) -> float:
    """Exact per-device bytes of a tree of (fake or meta) tensors placed
    by a tree of specs."""
    total = [0.0]

    def one(t, spec):
        denom = 1
        for ax in spec:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                denom *= mesh_axes[a]
        total[0] += t.numel() * t.element_size() / denom
    tree_map(one, tree, specs)
    return total[0]


def _abstract_params(cfg: ModelConfig):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return transformer.init_params(cfg, torch.Generator(), device="cpu")


@dataclasses.dataclass
class Cell:
    """One cell as :func:`build_cell` plans it: the plan the step runs
    on, the step's options and the size extras of the record."""
    plan: Plan
    kind: str
    options: Dict[str, Any]
    extra: Dict[str, Any]


def build_cell(cfg: ModelConfig, shape: ShapeConfig, plan: Plan,
               overrides: Optional[Dict[str, Any]] = None, *,
               arch: Optional[str] = None) -> Cell:
    """The reference's ``build_cell`` without the lowering: the cell's
    plan, its step options and its per-device size extras
    (``params_bytes_per_device``; ``state_bytes_per_device``,
    ``analytic_peak_bytes_per_device`` and ``n_microbatches`` for train;
    the cache bytes for serving), from shapes alone.  `arch` names the
    override entry (default ``cfg.name``)."""
    overrides = {**TRAIN_MEMORY_OVERRIDES.get(arch or cfg.name, {}),
                 **(overrides or {})}
    params = _abstract_params(cfg)
    axes = plan.mesh_axes
    if shape.kind in ("prefill", "decode"):
        # weight-stationary serving: TP-sharded leaves drop FSDP when the
        # TP shard fits HBM
        tp_shard_bytes = cfg.n_params() * 2 / axes[plan.tp_axis]
        if tp_shard_bytes < 10e9 and not overrides.get("keep_fsdp_serving"):
            plan = dataclasses.replace(plan, serving=True)
    pspec = plan.param_specs(params)
    params_dev = _sharded_bytes(params, pspec, axes)
    extra: Dict[str, Any] = {"params_bytes_per_device": params_dev}

    if shape.kind == "train":
        pure_dp = overrides.get("pure_dp") or (
            overrides.get("pure_dp_single") and "pod" not in axes)
        if pure_dp:
            plan = dataclasses.replace(plan, dp_axes=("data", "model"))
            pspec = plan.param_specs(params)
            n_mb = overrides.get("n_microbatches_pure_dp", 1)
        elif "pod" in axes and "n_microbatches_multi" in overrides:
            n_mb = overrides["n_microbatches_multi"]
        else:
            n_devices = 1
            for v in axes.values():
                n_devices *= v
            n_mb = overrides.get("n_microbatches") or microbatch_count(
                cfg, shape.global_batch, shape.seq_len, n_devices)
        moment_dtype = overrides.get("moment_dtype", torch.float32)
        accum_dtype = overrides.get("accum_dtype", torch.float32)
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode(allow_non_fake_inputs=True):
            state = make_train_state(cfg, params, moment_dtype)
        sspec = {"params": pspec, "opt": {"m": pspec, "v": pspec},
                 "step": Spec()}
        state_dev = _sharded_bytes(state, sspec, axes)
        mb_local = max(1, shape.global_batch // n_mb // plan.dp_size)
        layers = cfg.n_layers + cfg.n_encoder_layers
        stacks = layers * mb_local * shape.seq_len * cfg.d_model * 2
        if cfg.family == "hybrid":
            stacks *= 1.25
        if overrides.get("remat_policy") == "save_tp_out":
            stacks *= 3.0
        if overrides.get("save_sp"):
            # the saved TP outputs are kept as the residual stream holds
            # them, so they are split on the sequence only under sp
            if not overrides.get("sp"):
                raise ValueError("build_cell: save_sp needs sp")
            stacks = stacks * (2.0 / 3.0) / axes[plan.tp_axis] \
                + stacks / 3.0  # saved tp-outs sharded; layer inputs full
        accum_bytes = 2 * params_dev / cfg.param_dtype.itemsize \
            * accum_dtype.itemsize
        peak = state_dev + accum_bytes + params_dev + stacks + 2e9
        extra.update({"n_microbatches": n_mb,
                      "state_bytes_per_device": state_dev,
                      "analytic_peak_bytes_per_device": peak,
                      "moment_dtype": str(moment_dtype).replace("torch.", ""),
                      "accum_dtype": str(accum_dtype).replace("torch.", "")})
        options = dict(
            n_microbatches=n_mb, remat=overrides.get("remat", True),
            act_spec=plan.act_spec(sp=overrides.get("sp", False)),
            moe_groups=plan.dp_size,
            moe_ep_axis=overrides.get("moe_ep_axis", plan.tp_axis),
            accum_dtype=accum_dtype,
            remat_policy=overrides.get("remat_policy"),
            moment_dtype=moment_dtype)
        return Cell(plan, "train", options, extra)

    enc_len = (shape.seq_len if shape.kind == "prefill"
               else DEFAULT_ENC_LEN) if cfg.is_encoder_decoder else 0
    caches = transformer.init_caches(cfg, shape.global_batch, shape.seq_len,
                                     enc_len, device="meta")
    cache_dev = _sharded_bytes(caches, plan.cache_specs(cfg, caches), axes)
    ep = plan.tp_axis if plan.serving else None
    options = dict(moe_groups=plan.dp_size,
                   moe_ep_axis=overrides.get("moe_ep_axis", ep),
                   enc_len=enc_len)
    peak = (params_dev + 2 * cache_dev + 2e9 if shape.kind == "prefill"
            else params_dev + cache_dev + 1e9)
    extra.update({"cache_bytes_per_device": cache_dev,
                  "analytic_peak_bytes_per_device": peak})
    return Cell(plan, shape.kind, options, extra)


@contextmanager
def fake_world(mesh_axes: Dict[str, int], device_type: str = "cpu"):
    """A ``"fake"`` process group of the mesh's size (this process rank
    0) and its ``DeviceMesh`` on `device_type`; the group is destroyed on
    the way out."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already has a group")
    size = 1
    for v in mesh_axes.values():
        size *= v
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield init_device_mesh(device_type, tuple(mesh_axes.values()),
                               mesh_dim_names=tuple(mesh_axes))
    finally:
        dist.destroy_process_group()


def _fake_batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros(shp, dtype=_dtype_of(name, cfg),
                              device=device)
            for name, shp in batch_shapes(cfg, kind, batch, seq).items()}


def _to(tree: Any, device: torch.device) -> Any:
    """Fake tensors on `device`, made by a factory (a CPU-only build of
    torch moves no fake tensor to ``cuda``, but makes one)."""
    return tree_map(lambda t: t if t.device == device else
                    torch.empty_like(t, device=device), tree)


def _trace(cfg: ModelConfig, shape: ShapeConfig, cell: Cell, mesh,
           device: torch.device) -> Dict[str, Any]:
    """Build the cell's fake state on `mesh` and run its one step under
    the counters; returns the record's measured parts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    plan, opts = cell.plan, dict(cell.options)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _to(transformer.init_params(cfg, torch.Generator(),
                                             device="cpu"), device)
        if cell.kind == "train":
            state = make_train_state(cfg, params, opts.pop("moment_dtype"))
            held = parallel.distribute_tree(
                state, plan.param_specs(state), mesh)
        else:
            held = parallel.distribute_tree(
                params, plan.param_specs(params), mesh)
        batch = _fake_batch(cfg, shape.kind, shape.global_batch,
                            shape.seq_len, device)
        mem = MemTracker()
        args = [parallel.local(t) for t in tree_leaves(held)]
        mem.track_external(*args, *batch.values())
        argument_bytes = sum(t.numel() * t.element_size()
                             for t in args + list(batch.values()))
        flops, colls = FlopCounterMode(display=False), CollectiveCounter()
        t0 = time.perf_counter()
        with mem, flops, colls:
            if cell.kind == "train":
                step = make_train_step(cfg, **opts)
                step(held, batch)
            else:
                _serve(cfg, shape, cell, held, batch, device)
        trace_s = time.perf_counter() - t0
    peak = max((snap.get("Total", 0) for snap in
                mem.get_tracker_snapshot("peak").values()), default=0)
    return {"memory": {"argument_bytes": argument_bytes,
                       "output_bytes": 0,
                       "temp_bytes": max(peak - argument_bytes, 0),
                       "alias_bytes": 0,
                       "peak_bytes_per_device": peak},
            "cost_analysis": {"flops_per_device":
                              float(flops.get_total_flops()),
                              "bytes_per_device": None},
            "collectives": colls.bytes(), "trace_s": trace_s}


def _serve(cfg, shape, cell: Cell, params, batch, device) -> None:
    """One serving step on this rank: the weights gathered, the port's
    one-device prefill or decode step on the rank's batch rows."""
    ctx = parallel.context(params, batch)
    local = ctx.localize_tree(params, tree_map(lambda _: parallel.GATHER,
                                               params))
    rows = {k: ctx.local_batch(v) for k, v in batch.items()}
    opts = cell.options
    if cell.kind == "prefill":
        make_prefill_step(cfg, moe_groups=opts["moe_groups"],
                          moe_ep_axis=None)(local, rows)
        return
    caches = transformer.init_caches(cfg, rows["tokens"].shape[0],
                                     shape.seq_len, opts["enc_len"],
                                     device=device)
    make_decode_step(cfg, moe_groups=opts["moe_groups"],
                     moe_ep_axis=None)(local, caches, rows["tokens"],
                                       rows["pos"])


def _launches() -> Dict[str, int]:
    return {"mamba_scan": scan_ops.LAUNCHES,
            "mamba_scan_bwd": scan_ops.BWD_LAUNCHES,
            "mamba_ssm_bwd": scan_ops.SSM_BWD_LAUNCHES}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[Dict[str, Any]] = None,
             verbose: bool = True, *, device: str = "cpu",
             cfg: Optional[ModelConfig] = None,
             mesh_axes: Optional[Dict[str, int]] = None,
             shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """Trace one (arch x shape x mesh) cell on a fake group; derive the
    roofline terms.  `cfg` replaces ``configs.get(arch)`` (a reduced
    config, say; the overrides are still `arch`'s), `mesh_axes` the
    production mesh (axis name -> size) and `shape` ``SHAPES[shape_name]``.
    ``kernel_launches`` records the kernels' launch counts over the trace
    (0: the fake-tensor shape rules launch nothing)."""
    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    axes = mesh_axes or make_production_mesh(multi_pod=multi_pod)
    mesh_name = ("pod2x16x16" if multi_pod else "pod16x16") \
        if mesh_axes is None else "x".join(map(str, axes.values()))
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "kind": shape.kind,
                           "torch_version": torch.__version__}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update({"applicable": False, "skip_reason": why})
        return rec
    rec["applicable"] = True
    before = _launches()
    with fake_world(axes, torch.device(device).type) as mesh:
        cell = build_cell(cfg, shape, Plan.for_mesh(mesh), overrides,
                          arch=arch)
        rec.update(_trace(cfg, shape, cell, mesh, torch.device(device)))
    rec["kernel_launches"] = {k: n - before[k]
                              for k, n in _launches().items()}
    extra = cell.extra
    n_devices = mesh.size()
    n_mb = extra.get("n_microbatches", 1)
    tp = cell.plan.mesh_axes[cell.plan.tp_axis]
    cost = analytic.step_cost(cfg, shape, n_devices=n_devices, tp=tp,
                              n_microbatches=n_mb)
    rec["analytic"] = {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
                       "model_flops": cost.model_flops}
    rec.update({k: (float(v) if isinstance(v, (int, float)) else v)
                for k, v in extra.items()})
    rec["fits_hbm_analytic"] = bool(
        extra["analytic_peak_bytes_per_device"] < HBM_PER_CHIP)
    rec["n_devices"] = n_devices
    rec["terms"] = roofline_terms(
        flops_global=cost.flops, hbm_bytes_global=cost.hbm_bytes,
        collective_bytes_per_device=rec["collectives"]["total"],
        n_chips=n_devices, model_flops=cost.model_flops)
    if verbose:
        t, mem = rec["terms"], rec["memory"]
        print(f"[{mesh_name}] {arch} x {shape_name} on fake {device}: "
              f"peak/dev={mem['peak_bytes_per_device']/1e9:.2f}GB(traced) "
              f"analytic={extra['analytic_peak_bytes_per_device']/1e9:.2f}GB "
              f"fits={rec['fits_hbm_analytic']} "
              f"compute={t['compute_s']*1e3:.1f}ms "
              f"memory={t['memory_s']*1e3:.1f}ms "
              f"collective={t['collective_s']*1e3:.1f}ms "
              f"dominant={t['dominant']} "
              f"roofline_frac={t['roofline_fraction']:.3f} "
              f"(trace {rec['trace_s']:.2f}s)")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-pod dry-run")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="out/dryrun")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the fake tensors")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else configs.names()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                try:
                    rec = run_cell(arch, shape_name, multi,
                                   device=args.device)
                except Exception as e:  # a failure here is a bug in the system
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "pod2x16x16" if multi else "pod16x16",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(tag)
                    print(f"FAILED {tag}: {rec['error']}")
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("dry-run: all cells OK")


if __name__ == "__main__":
    main()
