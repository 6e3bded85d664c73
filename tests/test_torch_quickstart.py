"""examples/torch_quickstart.py against examples/quickstart.py: both run
in this process (the reference on the CPU's JAX device, the port with
``--device cpu``), and the values they print must agree -- the eight map
results, the HPC stage's value at ``.3e`` and the Mode-I map_reduce sum."""
import importlib.util
import re
import runpy
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load_port():
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", EXAMPLES / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(out: str) -> dict:
    """The three values both quickstarts print."""
    return {"maps": re.search(r"\[2\] map results: (\[.*\])", out)[1],
            "hpc": re.search(r"\[3\] HPC stage -> (\S+)", out)[1],
            "sum": re.search(r"map_reduce sum = (\d+)", out)[1]}


def test_quickstart_matches_reference(capsys):
    runpy.run_path(str(EXAMPLES / "quickstart.py"), run_name="__main__")
    want = _printed(capsys.readouterr().out)
    got = _load_port().main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert _printed(printed) == want
    assert want == {"maps": str([i * i for i in range(8)]),
                    "hpc": f"{sum(i * i for i in range(1024)):.3e}",
                    "sum": "8386560"}
    assert got["maps"] == [i * i for i in range(8)]
    assert got["sum"] == 8386560.0
    assert f"{got['hpc']:.3e}" == want["hpc"]
    assert "(cpu)" in printed and printed.rstrip().endswith("done.")


def test_quickstart_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_port().main([])
