"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: by the sources' imports, and by
the modules a whole run leaves loaded."""
from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

import pytest

from bench_support import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "out" not in p.relative_to(BENCH).parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(top_level_imports(path))


def test_no_source_reads_the_jax_era_benchmarks_folder():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        assert '"benchmarks' not in path.read_text()


def test_a_run_leaves_no_forbidden_module_loaded(tmp_path):
    """A whole CPU run of a cell in a fresh interpreter, then a look at
    sys.modules by whole top-level names."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(BENCH / 'tests')!r}]
        from pathlib import Path
        import bench_support
        root = bench_support.smoke_copy(Path({str(tmp_path)!r}))
        bench_support.run_cell(root, bench_support.SERVE_CELL, seconds=0.5)
        from lib import harness
        print(harness.forbidden_modules())
        print(sorted(m for m in sys.modules if m.split('.')[0] == 'repro_torch')[:1])
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT / "src"),
                              "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()
    assert last[-2] == "[]"
    assert last[-1].startswith("['repro_torch")


def test_harness_names_forbidden_modules_by_whole_top_level_name():
    from lib import harness
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                      "jaxlib.xla"]) == ["flax", "jax",
                                                         "jaxlib", "repro"]
