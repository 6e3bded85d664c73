"""The port's dry-run (``launch/dryrun.py``) against the reference's.

* Size parity: the reference's ``build_cell`` extras
  (``params_bytes_per_device``, ``state_bytes_per_device``,
  ``analytic_peak_bytes_per_device``, ``cache_bytes_per_device``) for
  all 10 configs x their applicable ``SHAPES`` on the (16, 16) and
  (2, 16, 16) production meshes, read in one subprocess (512 host
  devices; ``build_cell`` only calls ``eval_shape`` and ``jit``, nothing
  is lowered), equal the port's ``build_cell`` (rel 1e-12), the
  reference's ``n_microbatches`` handed to the port as its override.
* ``run_cell`` on smoke configs (llama3.2-1b dense, hymba-1.5b,
  qwen2-moe-a2.7b) on a fake (2, 2) and (16, 16) group with fake CPU
  tensors, each mesh in a subprocess of its own: the record's keys,
  collective bytes where the mesh splits anything, no kernel launched
  and no plain version called, and the traced FLOPs per device within
  the reference's 0.7-1.4 of the analytic count per device where every
  rank's work is its own share (on (16, 16) the smoke widths do not
  divide the model axis, so a model rank repeats replicated work,
  except for the archs the plan runs as pure data parallelism).  A
  prefill and a decode cell on (2, 2) too.
* The reference's ``sp``, ``remat_policy`` and ``save_sp`` overrides
  run a sequence-parallel step with the ``save_tp_out`` policy;
  ``save_sp`` without ``sp`` raises.
* The skip records equal the reference's ``shape_applicable``.
* The train cells' microbatch count is ``microbatch_count`` at the
  H100's 80 GB (``HBM_BYTES_PER_CHIP``), not the reference's 16 GB.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs
from repro_torch.core.resource_manager import HBM_BYTES_PER_CHIP
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES, ShapeConfig, shape_applicable
from repro_torch.sharding import Plan
from repro_torch.train.step import microbatch_count

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
SMOKE_ARCHS = ("llama3.2-1b", "hymba-1.5b", "qwen2-moe-a2.7b")
# a train cell small enough to trace in seconds at smoke width
SMOKE_TRAIN = ShapeConfig("train_4k", 256, 256, "train")
SERVE_CELLS = (ShapeConfig("prefill_32k", 128, 8, "prefill"),
               ShapeConfig("decode_32k", 128, 8, "decode"))
REFERENCE_EXTRAS = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
from repro.launch import dryrun
from repro import configs
from repro.launch.mesh import make_production_mesh
from repro.models.config import SHAPES, shape_applicable
from repro.sharding import Plan
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in configs.names():
        cfg = configs.get(arch)
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            _, _, extra = dryrun.build_cell(cfg, shape, mesh,
                                            Plan.for_mesh(mesh))
            out[f"{arch}|{name}|{int(multi)}"] = {
                k: v for k, v in extra.items()
                if isinstance(v, (int, float))}
print(json.dumps(out))
"""


def _subprocess(args, **env) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **env}
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=TIMEOUT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_build_cell_sizes_equal_the_reference():
    want = _subprocess(["-c", REFERENCE_EXTRAS])
    assert len(want) == 64     # 10 configs x applicable shapes x 2 meshes
    for key, ref in want.items():
        arch, name, multi = key.split("|")
        axes = make_production_mesh(multi_pod=bool(int(multi)))
        over = ({"n_microbatches": int(ref["n_microbatches"])}
                if "n_microbatches" in ref else None)
        cell = dryrun.build_cell(configs.get(arch), SHAPES[name],
                                 Plan.for_mesh(axes), over, arch=arch)
        for k, v in ref.items():
            assert math.isclose(cell.extra[k], v, rel_tol=1e-12), (key, k)


def _check_record(rec: dict, arch: str, mesh: str) -> None:
    for key in _record_keys(rec["kind"]):
        assert key in rec, (arch, mesh, key)
    assert rec["torch_version"] and rec["trace_s"] > 0
    assert rec["collectives"]["total"] > 0, (arch, mesh)
    assert not any(rec["kernel_launches"].values()), rec["kernel_launches"]
    assert rec["plain_calls"] == 0, (arch, mesh)
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"] > 0
    assert rec["fits_hbm_analytic"] == (
        rec["analytic_peak_bytes_per_device"] < HBM_BYTES_PER_CHIP)


def _record_keys(kind: str):
    keys = ["memory", "cost_analysis", "collectives", "analytic",
            "params_bytes_per_device", "analytic_peak_bytes_per_device",
            "fits_hbm_analytic", "terms", "trace_s", "torch_version",
            "kernel_launches", "n_devices"]
    if kind == "train":
        keys += ["state_bytes_per_device", "n_microbatches"]
    return keys


def _flop_ratio(rec: dict) -> float:
    return rec["cost_analysis"]["flops_per_device"] / (
        rec["analytic"]["flops"] / rec["n_devices"])


@pytest.mark.parametrize("mesh", ["2x2", "16x16"])
def test_run_cell_on_smoke_configs(mesh):
    recs = _subprocess([__file__, "train", mesh, *SMOKE_ARCHS])
    for arch in SMOKE_ARCHS:
        rec = recs[arch]
        _check_record(rec, arch, mesh)
        assert rec["n_devices"] == (4 if mesh == "2x2" else 256)
        cfg = configs.get_smoke(arch)
        pure_dp = dryrun.TRAIN_MEMORY_OVERRIDES.get(
            arch, {}).get("pure_dp_single")
        if not pure_dp:
            # the microbatch count at the H100's 80 GB
            assert rec["n_microbatches"] == microbatch_count(
                cfg, SMOKE_TRAIN.global_batch, SMOKE_TRAIN.seq_len,
                rec["n_devices"], hbm_bytes=HBM_BYTES_PER_CHIP)
        if mesh == "2x2" or pure_dp:
            assert 0.7 < _flop_ratio(rec) < 1.4, (arch, _flop_ratio(rec))


def test_run_cell_with_the_reference_overrides():
    """The reference's memory overrides ``sp``, ``remat_policy`` and
    ``save_sp`` on a cell that is not pure data parallel: the step runs
    sequence-parallel (reduce-scatters on the sequence) with the
    ``save_tp_out`` policy, and the analytic peak takes the reference's
    factors for them."""
    arch = "qwen2-moe-a2.7b"
    plain, sp = (_subprocess([__file__, kind, "2x2", arch])[arch]
                 for kind in ("train", "train-sp"))
    _check_record(sp, arch, "2x2")
    assert 0.7 < _flop_ratio(sp) < 1.4
    assert sp["collectives"]["reduce-scatter"] > \
        plain["collectives"]["reduce-scatter"]
    assert sp["analytic_peak_bytes_per_device"] != \
        plain["analytic_peak_bytes_per_device"]


def test_run_cell_serving_on_a_fake_group():
    recs = _subprocess([__file__, "serve", "2x2", "llama3.2-1b"])
    for kind in ("prefill", "decode"):
        rec = recs[kind]
        assert rec["kind"] == kind
        _check_record(rec, "llama3.2-1b", "2x2")
        assert rec["cache_bytes_per_device"] > 0


@pytest.mark.parametrize("arch", configs.names())
def test_skip_records_equal_the_reference(arch):
    from repro import configs as jconfigs
    from repro.models.config import SHAPES as JSHAPES
    from repro.models.config import shape_applicable as japplicable
    for name, shape in SHAPES.items():
        want = japplicable(jconfigs.get(arch), JSHAPES[name])
        assert shape_applicable(configs.get(arch), shape) == want
        if not want[0]:
            rec = dryrun.run_cell(arch, name, False, verbose=False)
            assert rec == {"arch": arch, "shape": name, "mesh": "pod16x16",
                           "kind": shape.kind,
                           "torch_version": rec["torch_version"],
                           "applicable": False, "skip_reason": want[1]}


def test_train_microbatches_at_80_gb():
    """Falcon-Mamba-7B's train_4k cell on (16, 16) has no override: one
    microbatch at the H100's 80 GB, where 16 GB would take 8."""
    cfg, shape = configs.get("falcon-mamba-7b"), SHAPES["train_4k"]
    axes = make_production_mesh()
    cell = dryrun.build_cell(cfg, shape, Plan.for_mesh(axes))
    n = microbatch_count(cfg, shape.global_batch, shape.seq_len, 256,
                         hbm_bytes=HBM_BYTES_PER_CHIP)
    assert cell.extra["n_microbatches"] == cell.options["n_microbatches"] \
        == n == 1
    assert microbatch_count(cfg, shape.global_batch, shape.seq_len, 256,
                            hbm_bytes=16e9) == 8
    assert dryrun.HBM_PER_CHIP == HBM_BYTES_PER_CHIP


def test_save_sp_needs_sequence_parallelism():
    """The port keeps the saved TP outputs as the residual stream holds
    them, so the reference's ``save_sp`` (saved outputs split on the
    sequence) takes ``sp``: with it the analytic peak shrinks by the
    reference's factor, without it the cell raises."""
    cfg, shape = configs.get("internlm2-1.8b"), SHAPES["train_4k"]
    plan = Plan.for_mesh(make_production_mesh())
    over = {"sp": True, "remat_policy": "save_tp_out"}
    peak = [dryrun.build_cell(cfg, shape, plan, {**over, **extra})
            .extra["analytic_peak_bytes_per_device"]
            for extra in ({}, {"save_sp": True})]
    assert peak[1] < peak[0]
    with pytest.raises(ValueError, match="save_sp needs sp"):
        dryrun.build_cell(cfg, shape, plan, {"save_sp": True})


# ------------------------------------------------------- the subprocess
def _counted_plain_calls() -> list:
    """Wrap the plain versions of K3, K3-bwd and the fused backward to
    count their calls."""
    from repro_torch.kernels.mamba_scan import ref
    calls = [0]
    for name in ("scan", "scan_backward", "ssm_backward"):
        real = getattr(ref, name)

        def wrapped(*a, _real=real, **k):
            calls[0] += 1
            return _real(*a, **k)
        setattr(ref, name, wrapped)
    return calls


def _cells(kind: str, mesh: str, *archs: str) -> dict:
    calls = _counted_plain_calls()
    axes = dict(zip(("data", "model"), map(int, mesh.split("x"))))
    out = {}
    train = kind.startswith("train")
    overrides = ({"sp": True, "remat_policy": "save_tp_out", "save_sp": True}
                 if kind == "train-sp" else None)
    shapes = ({a: SMOKE_TRAIN for a in archs} if train else
              {s.kind: s for s in SERVE_CELLS})
    for key, shape in shapes.items():
        arch = key if train else archs[0]
        before = calls[0]
        rec = dryrun.run_cell(arch, shape.name, False, overrides,
                              verbose=False, device="cpu",
                              cfg=configs.get_smoke(arch), mesh_axes=axes,
                              shape=shape)
        rec["plain_calls"] = calls[0] - before
        out[key] = rec
    return out


if __name__ == "__main__":
    print(json.dumps(_cells(*sys.argv[1:])))
