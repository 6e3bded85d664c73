"""Test settings shared by the test files: the ``cuda`` marker.

Tests marked ``cuda`` run a hand-written kernel on a CUDA card and skip
without one (the check is made inside a fixture, never at import).  They
live in files that import no JAX; on a machine with the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mamba_scan_cuda.py``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
