"""The port stands alone: no module of ``repro_torch``, no
``examples/torch_*.py`` and not ``chip_smoke.py`` imports JAX or the JAX
package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_scan_covers_the_port():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "dataplane.py", "ops.py", "kmeans.py",
            "autotune.py", "platform.py", "flash_attention.py",
            "mamba_scan.py"} <= names
    rel = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES
           if "repro_torch" in p.parts}
    assert {f"kernels/{k}/ops.py"
            for k in ("kmeans", "flash_attention", "mamba_scan")} <= rel
    assert {"core/session.py", "core/raptor.py", "core/chaos.py",
            "roofline/placement.py", "roofline/terms.py"} <= rel
    assert {"models/config.py", "models/transformer.py", "util.py",
            "data/batches.py", "serve/step.py", "configs/__init__.py",
            "serve/engine.py", "serve/kv_pages.py", "serve/router.py",
            "launch/serve.py"} \
        | {f"models/layers/{m}.py"
           for m in ("common", "attention", "mamba", "moe")} <= rel
    assert {"optim/adamw.py", "optim/schedule.py", "optim/compression.py",
            "train/step.py", "train/trainer.py", "train/multi_pilot.py",
            "data/pipeline.py", "checkpoint/manager.py",
            "launch/train.py"} <= rel
    assert {"sharding/__init__.py", "sharding/planner.py",
            "sharding/parallel.py", "launch/mesh.py", "launch/spmd.py"} <= rel
    assert {"torch_train_e2e.py", "torch_hybrid_pipeline.py",
            "torch_serve_batch.py"} <= names
    configs = {p.name for p in (ROOT / "src" / "repro" / "configs").glob(
        "*.py")}
    assert {f"configs/{name}" for name in configs} <= rel


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", ["repro_torch.analytics",
                                    "repro_torch.convert",
                                    "repro_torch.core.session",
                                    "repro_torch.roofline",
                                    "repro_torch.models.transformer",
                                    "repro_torch.data.batches",
                                    "repro_torch.serve",
                                    "repro_torch.launch.serve",
                                    "repro_torch.optim",
                                    "repro_torch.data.pipeline",
                                    "repro_torch.checkpoint",
                                    "repro_torch.train",
                                    "repro_torch.train.trainer",
                                    "repro_torch.train.multi_pilot",
                                    "repro_torch.launch.train",
                                    "repro_torch.sharding",
                                    "repro_torch.sharding.parallel",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.spmd"])
def test_each_entry_module_imports_first(module):
    """No import cycle: each module imports on its own in a fresh
    interpreter (the Session imports ``convert``, which needs the
    analytics engine, which imports the core)."""
    import subprocess
    import sys
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", f"import {module}"],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("module", ["repro_torch.core.session",
                                    "repro_torch.convert",
                                    "repro_torch.analytics.engine"])
def test_lower_layers_do_not_load_the_model_stack(module):
    """The core, ``convert`` and the analytics engine share their helpers
    through ``repro_torch.util``: importing one of them loads neither the
    model stack nor, through it, the selective-scan kernel, nor the
    trainer and the checkpoints."""
    import subprocess
    import sys
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    code = (f"import sys, {module}; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('repro_torch.models', 'repro_torch.kernels.mamba_scan', "
            "'repro_torch.train', 'repro_torch.checkpoint', "
            "'repro_torch.data.pipeline'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout
