"""Block-size autotuner for the Hopper kernels + cached best-config registry.

The kernels ship with default block sizes (:data:`DEFAULTS`) that need
not be the best on every shape.  This module sweeps the block sizes each
CUDA kernel is built for, filtered by the kernel's own shared-memory
formula, through timed trials on the card, and persists the winner in a
JSON registry keyed by ``(kernel, shape-bucket, backend, dtype)``.  The
``ops.py`` wrappers consult the registry by default — :func:`lookup` is
a dict probe, no timing — and use :data:`DEFAULTS` on a miss.

The registry's format and keys are the reference package's, so one file
can hold both: the reference writes ``cpu+interpret``/``tpu`` entries,
the port ``cuda`` entries (and ``cpu+plain`` for the plain versions,
which are never mistaken for kernel timings).

Registry location: ``REPRO_AUTOTUNE_REGISTRY`` env var, else
``~/.cache/repro/autotune.json``.  A corrupt registry file degrades to
an empty one (defaults win) instead of crashing the caller.

CLI (on the card; ``--device cpu`` times the plain versions):

    PYTHONPATH=src python -m repro_torch.kernels.autotune all
    PYTHONPATH=src python -m repro_torch.kernels.autotune flash_attention \\
        --shapes '{"S_q": 2048, "S_k": 2048, "hd": 128}' --reps 5
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.kmeans import kmeans as km_kernel
from repro_torch.kernels.mamba_scan import mamba_scan as ms_kernel

KERNELS = ("flash_attention", "kmeans", "mamba_scan", "mamba_scan_fused")

# the shipped block sizes — the fallback when the registry has no entry,
# and the baseline every speedup is reported against
DEFAULTS: Dict[str, Dict[str, int]] = {
    # 128 query rows per block (8 warps of 16 rows on mma.sync) and
    # 64-key tiles in a 2-stage ring: in f32 a block takes 102 KB of
    # shared memory at hd 64 (2 blocks fit on an SM) and 198 KB at hd
    # 128; Hymba-1.5B at S = 4096 gives 800 blocks for 132 SMs
    "flash_attention": {"bq": 128, "bk": 64},
    # 128 threads of 4 points (512 points a block at d <= 8) and tiles
    # of 256 packed centroids (4 KB at d = 3); ops.split_count splits k
    # at the paper's 10k x 5000 (20 splits) and 100k x 500 (2) to fill
    # the card.  Fastest summed over the paper's three shapes of the
    # grid tools/kmeans_blocks.py times on an H100.
    "kmeans": {"bn": 128, "bk": 256},
    # 8 d_inner rows of 16 state lanes = 128 threads; 400 blocks at
    # Hymba-1.5B width (di 3200), so all are resident at once; 8 steps
    # of loads (96 bytes a lane) in flight ahead of the recurrence
    "mamba_scan": {"bdi": 8, "bs": 8},
    # K3's fused mode (dt, u, Bc, C in; a and b formed in registers):
    # bdi 0 takes the rows that spread the blocks evenly over the SMs
    # (mamba_scan.balanced_rows: 100 rows of 4 lanes, 128 blocks of 416
    # threads at Hymba-1.5B's training shape, 4 x 3200); chunks of 64
    # steps staged ahead (116 KB).  Fastest of candidates_mamba_fused's
    # grid at that shape and at Falcon-Mamba-7B's on an H100
    "mamba_scan_fused": {"bdi": 0, "bs": 64},
}

# shared memory a block may use: 48 KB without opt-in; up to 227 KB
# (232,448 bytes) after cudaFuncSetAttribute, which the flash-attention
# kernel sets (H100 SXM, NVIDIA Hopper tuning guide)
SMEM_DEFAULT_BYTES = 48 * 1024
SMEM_OPTIN_MAX_BYTES = 232_448

# the dims each ops wrapper looks its block sizes up by; the registry key
# is bucketed over these, so a tuned entry is found by the wrapper
KEY_DIMS: Dict[str, Tuple[str, ...]] = {
    "flash_attention": ("S_q", "S_k", "hd"),
    "kmeans": ("n", "k", "d"),
    "mamba_scan": ("S", "di", "st"),
    "mamba_scan_fused": ("S", "di", "st"),
}

# candidate block sizes: the sizes each kernel is built for
_FLASH_BQ = (32, 64, 128)                # query rows, 16 per warp
_FLASH_BK = fa_kernel.BK_BUILT           # keys per tile, instantiated
_KMEANS_BN = (32, 64, 128, 256, 512)     # threads per block, whole warps
_KMEANS_BK = (32, 64, 128, 256, 512, 1024)     # centroids per tile
_MAMBA_BDI = (1, 2, 4, 8, 16, 32)        # d_inner rows per block
_FUSED_BDI = (16, 32, 64, 128)          # the same, the fused mode's


# --------------------------------------------------------------- snapping
def snap_block(n: int, b: int) -> int:
    """Largest divisor of ``n`` that is <= ``b`` (>= 1).  Kept for the
    reference's callers; the Hopper kernels mask their own ragged edge,
    so the port's wrappers do not snap."""
    b = max(1, min(b, n))
    while n % b:
        b -= 1
    return b


def _bucket(n: int) -> int:
    """Shape bucket: next power of two >= n (shapes in one bucket share
    a tuned config — tuning is amortized across nearby sizes)."""
    p = 1
    while p < n:
        p *= 2
    return p


def shape_bucket(kernel: str, shape: Dict[str, int]) -> str:
    dims = sorted(shape.items())
    return ",".join(f"{k}{_bucket(int(v))}" for k, v in dims)


# --------------------------------------------------------------- registry
def _default_path() -> str:
    return os.environ.get(
        "REPRO_AUTOTUNE_REGISTRY",
        os.path.join(os.path.expanduser("~"), ".cache", "repro",
                     "autotune.json"))


class Registry:
    """JSON best-config store keyed ``kernel|shape-bucket|backend|dtype``.

    Tolerant by design: a corrupt or unreadable file loads as empty
    (``corrupt`` flag set) so kernels silently fall back to defaults —
    a stale cache must never take the hot path down.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or _default_path()
        self.corrupt = False
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = self._load()

    def _load(self) -> Dict[str, Dict[str, Any]]:
        try:
            with open(self.path) as f:
                data = json.load(f)
            if not isinstance(data, dict) or not all(
                    isinstance(v, dict) for v in data.values()):
                raise ValueError("registry root must be a dict of dicts")
            return data
        except FileNotFoundError:
            return {}
        except (ValueError, OSError):
            self.corrupt = True
            return {}

    @staticmethod
    def key(kernel: str, bucket: str, backend: str, dtype: str) -> str:
        return f"{kernel}|{bucket}|{backend}|{dtype}"

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._entries.get(key)

    def put(self, key: str, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._entries[key] = entry

    def save(self) -> None:
        with self._lock:
            entries = dict(self._entries)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(entries, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_default_registry: Optional[Registry] = None
_registry_lock = threading.Lock()


def default_registry(reload: bool = False) -> Registry:
    """Process-wide registry the ops wrappers probe (lazy-loaded)."""
    global _default_registry
    with _registry_lock:
        if (_default_registry is None or reload
                or _default_registry.path != _default_path()):
            _default_registry = Registry()
        return _default_registry


def backend_tag(device: Union[str, torch.device]) -> str:
    """Registry backend axis: ``cuda`` for the card's kernels,
    ``cpu+plain`` for the plain versions a CPU tensor runs (their
    timings must never be mistaken for kernel timings)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "cpu+plain"
    raise ValueError(f"no kernel or plain version for device {device}")


def dtype_name(dtype: torch.dtype) -> str:
    """The registry's dtype axis: numpy's name (``float32``, ``bfloat16``)."""
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"expected a torch.dtype, got {dtype!r}")
    return str(dtype).removeprefix("torch.")


def _key(kernel: str, shape: Dict[str, int], dtype: torch.dtype,
         device) -> str:
    dims = {d: int(shape[d]) for d in KEY_DIMS[kernel]}
    return Registry.key(kernel, shape_bucket(kernel, dims),
                        backend_tag(device), dtype_name(dtype))


def lookup(kernel: str, shape: Dict[str, int], dtype: torch.dtype,
           device) -> Optional[Dict[str, int]]:
    """Cheap best-config probe for the ops wrappers: dict lookup on the
    in-memory registry, None on miss (caller falls back to DEFAULTS)."""
    reg = default_registry()
    if not len(reg):
        return None
    entry = reg.get(_key(kernel, shape, dtype, device))
    return dict(entry["config"]) if entry else None


# ------------------------------------------------------------- candidates
def candidates_flash(S_q: int, S_k: int, hd: int,
                     budget: int = SMEM_OPTIN_MAX_BYTES
                     ) -> List[Dict[str, int]]:
    """(bq, bk) grid the kernel is built for, filtered by its shared
    memory in f32 (the larger element): the query tile and two stages of
    K and V tiles."""
    return [{"bq": bq, "bk": bk}
            for bq in _FLASH_BQ for bk in _FLASH_BK
            if fa_kernel.smem_bytes(bq, bk, hd) <= budget]


def candidates_kmeans(n: int, k: int, d: int,
                      budget: int = SMEM_DEFAULT_BYTES
                      ) -> List[Dict[str, int]]:
    """(bn, bk) grid for the assignment scan, capped at the bucketed
    threads n needs (``rows(d)`` points a thread) and the bucketed k
    (larger blocks do the same work), filtered by what the scan takes
    and by its shared memory: a tile of bk packed centroids."""
    out, seen = [], set()
    threads = -(-n // km_kernel.rows(d))
    for bn_w in _KMEANS_BN:
        for bk_w in _KMEANS_BK:
            bn = min(bn_w, _bucket(max(threads, 32)))
            bk = min(bk_w, _bucket(max(k, 8)))
            if not km_kernel.accepts(bn, bk, d) \
                    or km_kernel.smem_bytes(bk, d) > budget \
                    or (bn, bk) in seen:
                continue
            seen.add((bn, bk))
            out.append({"bn": bn, "bk": bk})
    return out


def candidates_mamba(S: int, di: int, st: int) -> List[Dict[str, int]]:
    """(bdi, bs) grid: bdi rows of d_inner per block, capped at the
    bucketed d_inner and at the kernel's largest block; bs the time steps
    the kernel is built to load ahead.  The scan uses no shared memory."""
    out, seen = [], set()
    for bdi_w in _MAMBA_BDI:
        for bs in ms_kernel.BS_BUILT:
            bdi = min(bdi_w, _bucket(di))
            if ms_kernel.threads(bdi, st) > ms_kernel.MAX_THREADS \
                    or (bdi, bs) in seen:
                continue
            seen.add((bdi, bs))
            out.append({"bdi": bdi, "bs": bs})
    return out


def candidates_mamba_fused(S: int, di: int, st: int
                           ) -> List[Dict[str, int]]:
    """(bdi, bs) grid of K3's fused mode: bdi rows of d_inner per block,
    capped at the bucketed d_inner, or 0 (the rows that spread the blocks
    evenly over the card); bs the steps of a staged chunk; filtered by
    what the kernel takes (threads, shared memory)."""
    out = [{"bdi": 0, "bs": bs} for bs in ms_kernel.FUSED_BS_BUILT]
    seen = set()
    for bdi_w in _FUSED_BDI:
        for bs in ms_kernel.FUSED_BS_BUILT:
            bdi = min(bdi_w, _bucket(di))
            if not ms_kernel.fused_accepts(bdi, st, bs) or (bdi, bs) in seen:
                continue
            seen.add((bdi, bs))
            out.append({"bdi": bdi, "bs": bs})
    return out


# ----------------------------------------------------------- timed trials
BENCH_SHAPES: Dict[str, Dict[str, int]] = {
    # full widths of the repo's configs: flash at Hymba-1.5B's windowed
    # layers (25 heads, hd 64, window 2048) at S = 4096, kmeans at the
    # paper's 10k x 5000 scenario, mamba at Hymba-1.5B's d_inner 3200
    "flash_attention": {"B": 1, "H": 25, "S_q": 4096, "S_k": 4096,
                        "hd": 64, "causal": 1, "window": 2048},
    "kmeans": {"n": 10_000, "k": 5_000, "d": 3},
    "mamba_scan": {"B": 1, "S": 4096, "di": 3200, "st": 16},
    # the fused mode at Hymba-1.5B's training microbatch (4 x 2048)
    "mamba_scan_fused": {"B": 4, "S": 2048, "di": 3200, "st": 16},
}


def _time_call(fn, reps: int, device: torch.device) -> float:
    """Warm up (first launch builds and loads the kernel), then the mean
    seconds of ``reps`` calls: CUDA events on the card, the host clock
    on the CPU."""
    if device.type != "cuda":
        fn()
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        return (time.monotonic() - t0) / reps
    with torch.cuda.device(device):
        fn()
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps


def _make_cell(kernel: str, shape: Dict[str, int], dtype: torch.dtype,
               device: torch.device):
    """Drive-one-cell closure: returns ``run(config) -> timed callable``
    plus the candidate list.  Inputs come from a seeded generator on
    `device`."""
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*size, scale=1.0):
        return (torch.randn(*size, generator=gen, device=device)
                * scale).to(dtype)

    if kernel == "flash_attention":
        from repro_torch.kernels.flash_attention import ops as fa
        B, H = shape.get("B", 1), shape.get("H", 4)
        S_q, S_k, hd = shape["S_q"], shape.get("S_k", shape["S_q"]), shape["hd"]
        causal, window = bool(shape.get("causal", 1)), shape.get("window", 0)
        q = normal(B, S_q, H, hd, scale=0.3)
        k = normal(B, S_k, H, hd, scale=0.3)
        v = normal(B, S_k, H, hd)

        def run(cfg):
            return lambda: fa.attention(q, k, v, causal=causal, window=window,
                                        bq=cfg["bq"], bk=cfg["bk"])
        return run, candidates_flash(S_q, S_k, hd)

    if kernel == "kmeans":
        from repro_torch.kernels.kmeans import ops as km
        n, k_, d = shape["n"], shape["k"], shape["d"]
        p, c = normal(n, d), normal(k_, d)

        def run(cfg):
            return lambda: km.assign(p, c, bn=cfg["bn"], bk=cfg["bk"])
        return run, candidates_kmeans(n, k_, d)

    if kernel == "mamba_scan":
        from repro_torch.kernels.mamba_scan import ops as ms
        B, S, di, st = shape["B"], shape["S"], shape["di"], shape["st"]
        a = (0.8 + 0.19 * torch.rand(B, S, di, st, generator=gen,
                                     device=device)).to(dtype)
        b = normal(B, S, di, st, scale=0.1)
        C = normal(B, S, st)
        h0 = torch.zeros(B, di, st, dtype=dtype, device=device)

        def run(cfg):
            return lambda: ms.scan(a, b, C, h0, bdi=cfg["bdi"], bs=cfg["bs"])
        return run, candidates_mamba(S, di, st)

    if kernel == "mamba_scan_fused":
        from repro_torch.kernels.mamba_scan import ops as ms
        B, S, di, st = shape["B"], shape["S"], shape["di"], shape["st"]
        f32 = dict(dtype=torch.float32, device=device)
        # dt after a softplus, A = -exp(A_log) < 0, as a Mamba layer's
        dt = 0.001 + 0.1 * torch.rand(B, S, di, generator=gen, **f32)
        A = -torch.arange(1, st + 1, **f32).expand(di, st).contiguous()
        u = dt * torch.randn(B, S, di, generator=gen, **f32)
        Bc = torch.randn(B, S, st, generator=gen, **f32)
        C = torch.randn(B, S, st, generator=gen, **f32)
        h0 = torch.zeros(B, di, st, **f32)

        def run(cfg):
            return lambda: ms.selective_scan(dt, A, u, Bc, C, h0,
                                             bdi=cfg["bdi"], bs=cfg["bs"])
        return run, candidates_mamba_fused(S, di, st)

    raise ValueError(f"unknown kernel {kernel!r}; valid: {KERNELS}")


def autotune(kernel: str, shape: Optional[Dict[str, int]] = None, *,
             dtype: torch.dtype = torch.float32,
             device: Union[str, torch.device] = "cuda", reps: int = 3,
             registry: Optional[Registry] = None, force: bool = False,
             max_candidates: Optional[int] = None) -> Dict[str, Any]:
    """Tune one kernel at one shape on `device`; persist the winner.

    Returns ``{"config", "trials", "cached", "key", "speedup_vs_default",
    ...}``.  A registry hit short-circuits with ``trials == 0`` unless
    ``force`` — re-timing on every process start would defeat the cache.
    """
    device = torch.device(device)
    if kernel == "mamba_scan_fused":
        dtype = torch.float32           # the fused mode takes f32 alone
    shape = {**BENCH_SHAPES[kernel], **(shape or {})}
    # `registry or ...` would be wrong here: an EMPTY Registry is falsy
    reg = registry if registry is not None else default_registry()
    key = _key(kernel, shape, dtype, device)
    hit = reg.get(key)
    if hit is not None and not force:
        return {**hit, "key": key, "trials": 0, "cached": True}

    run, cands = _make_cell(kernel, shape, dtype, device)
    default_cfg = dict(DEFAULTS[kernel])
    if default_cfg not in cands:
        cands = [default_cfg] + cands      # the winner is never worse
    if max_candidates is not None and len(cands) > max_candidates:
        # keep the default + an even spread (smoke runs stay bounded)
        keep = [default_cfg]
        stride = max(1, len(cands) // max_candidates)
        keep += [c for c in cands[::stride] if c != default_cfg]
        cands = keep[:max_candidates + 1]

    timings: List[Tuple[float, Dict[str, int]]] = []
    for cfg in cands:
        timings.append((_time_call(run(cfg), reps, device), cfg))
    best_t, best_cfg = min(timings, key=lambda tc: tc[0])
    default_t = next(t for t, c in timings if c == default_cfg)
    entry = {
        "config": best_cfg,
        "default_config": default_cfg,
        "best_s": best_t,
        "default_s": default_t,
        "speedup_vs_default": default_t / max(best_t, 1e-12),
        "shape": shape,
        "n_candidates": len(cands),
        "reps": reps,
    }
    reg.put(key, entry)
    reg.save()
    return {**entry, "key": key, "trials": len(cands), "cached": False}


# -------------------------------------------------------------------- CLI
def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """Tune the named kernel family (or all) and print each winner;
    returns the records :func:`autotune` gave."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=list(KERNELS) + ["all"],
                    help="kernel family to tune (or 'all')")
    ap.add_argument("--shapes", default=None, metavar="JSON",
                    help="shape overrides, e.g. '{\"S_q\": 2048}'")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--registry", default=None,
                    help="registry path (default: REPRO_AUTOTUNE_REGISTRY "
                         "or ~/.cache/repro/autotune.json)")
    ap.add_argument("--force", action="store_true",
                    help="re-time even on a registry hit")
    args = ap.parse_args(argv)

    from repro_torch.launch import platform as _platform
    device = torch.device(args.device)
    _platform.configure(device.type)        # before the first CUDA call
    dtype = getattr(torch, args.dtype)
    shape = json.loads(args.shapes) if args.shapes else None
    reg = Registry(args.registry) if args.registry else default_registry()
    kernels = KERNELS if args.kernel == "all" else (args.kernel,)
    records = []
    for kern in kernels:
        rec = autotune(kern, shape, dtype=dtype, device=device,
                       reps=args.reps, registry=reg, force=args.force)
        src = "cache" if rec["cached"] else f"{rec['trials']} trials"
        print(f"{kern}: {rec['config']} "
              f"({rec['speedup_vs_default']:.2f}x vs default "
              f"{rec['default_config']}, {src})")
        records.append(rec)
    print(f"registry: {reg.path} ({len(reg)} entries)")
    return records


if __name__ == "__main__":
    main()
