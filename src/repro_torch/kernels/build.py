"""Build hand-written CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository root,
then loaded with :mod:`ctypes`.  The library's file name carries a digest
of the source and the flags, so an edited source is never served from a
stale build.  Builds happen at first use (never at import) or all at
once through :func:`build_all`, which starts one ``nvcc`` per source in
parallel.  ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside each library as ``<lib>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME
    (default ``/usr/local/cuda``).  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _start(source: Path) -> Tuple[Path, Path, subprocess.Popen]:
    target = library_path(source)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    log = open(target.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return target, tmp, proc


def build_all(sources: Sequence[Path]) -> float:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns the wall seconds spent; raises with
    the compiler's log on the first failure."""
    t0 = time.monotonic()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List[Tuple[Path, Path, subprocess.Popen]] = [
        _start(Path(s)) for s in sources if not library_path(Path(s)).exists()]
    failed = []
    for target, tmp, proc in jobs:
        if proc.wait() == 0:
            os.replace(tmp, target)
        else:
            failed.append(target.with_suffix(".log"))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {log}\n{log.read_text()}" for log in failed))
    return time.monotonic() - t0


def load(source: Path) -> ctypes.CDLL:
    """The loaded library for `source`, built first if needed."""
    source = Path(source)
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build_all([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _loaded[source] = lib
        return lib


def build_log(source: Path) -> str:
    """The compiler's report for `source`'s current library ('' if it was
    built by an earlier process and the log is gone)."""
    log = library_path(Path(source)).with_suffix(".log")
    return log.read_text() if log.exists() else ""
