"""K-Means CUs on a pilot, from clients in a closed loop: the paper's
analytics workload (Fig 6) run as Compute-Units.

Configuration (``configs/<config>.json``): the scenarios (points x
clusters), the dimension, the iterations, how the points are drawn
(a Gaussian mixture) and the pilot's slots.  Traffic
(``workloads/<cell>.json``): ``clients`` that each submit one fit at a
time and wait for it, taking the scenarios in turn from an offset of
their own; ``data_path`` (``local`` or ``global``); ``check_fits``, how
many finished fits the reference redoes; ``warmup_rounds``.

Every dataset is drawn on the device from the seed during set-up and put
on the pilot's data plane; each CU is one ``kmeans_fit`` with K1 on one
of them, its centroid seed derived from the run's seed, its client and
its turn.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List

import torch

from lib import seeds

TIMEOUT_S = 120.0


def make_points(n: int, d: int, mix: Dict[str, Any], seed: int,
                device) -> torch.Tensor:
    """n points in d dimensions from a mixture of Gaussians: centres
    uniform in [-r, r]^d, each point a centre plus normal noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r, comps = float(mix["center_range"]), int(mix["components"])
    centers = (torch.rand((comps, d), generator=gen, device=device)
               * (2 * r) - r)
    which = torch.randint(0, comps, (n,), generator=gen, device=device)
    noise = torch.randn((n, d), generator=gen, device=device)
    return centers[which] + noise * float(mix["noise"])


def jobs(run, client: int, turn: int):
    """(scenario index, centroid seed) of a client's turn."""
    n_sc = len(run.config["scenarios"])
    return ((client + turn) % n_sc,
            seeds.derive(run.seed, "fit", client, turn) % (1 << 62))


def setup(run) -> None:
    from repro_torch.analytics import kmeans as km
    from repro_torch.analytics.engine import AnalyticsEngine
    from repro_torch.core import (ComputeUnitDescription, DataPlane,
                                  DeviceGrid, PilotDescription, PilotManager,
                                  ResourceManager)
    cfg, tr, dev = run.config, run.traffic, run.device
    t0 = time.monotonic()
    pm = PilotManager(ResourceManager(devices=[dev] * cfg["pilot_slots"]))
    data = DataPlane()
    # the pilot's straggler speculation (on by default) would start a
    # second copy of a fit whenever one ran long: work that depends on
    # timing, not on the seed
    pilot = pm.submit(PilotDescription(n_chips=cfg["pilot_slots"],
                                       name=run.cell.name,
                                       enable_speculation=False),
                      data_registry=data)
    run.part("pilot", t0)

    t0 = time.monotonic()
    engines, points = [], []
    for i, sc in enumerate(cfg["scenarios"]):
        pts = make_points(sc["points"], cfg["dim"], cfg["points"],
                          seeds.derive(run.seed, "points", i), dev)
        eng = AnalyticsEngine(DeviceGrid([dev]), data)
        eng.put(sc["name"], pts)
        engines.append(eng)
        points.append(pts)
    run.sync()
    run.part("datasets", t0)

    def fit(s: int, fit_seed: int, mesh=None):
        sc = cfg["scenarios"][s]
        with run.spans.span("bench.fit", scenario=s):
            cents, cost = km.kmeans_fit(
                engines[s], sc["name"], sc["clusters"], iters=cfg["iters"],
                data_path=tr["data_path"], use_kernel=True, seed=fit_seed)
        return cents, cost

    def submit(s: int, fit_seed: int):
        return pilot.submit(ComputeUnitDescription(
            fn=fit, args=(s, fit_seed), n_chips=1, tag="kmeans",
            needs_mesh=True))

    # warm-up: every scenario through the pilot, alone and side by side
    t0 = time.monotonic()
    for r in range(int(tr.get("warmup_rounds", 2))):
        cus = [submit(s, seeds.derive(run.seed, "warm", r, s) % (1 << 62))
               for s in range(len(cfg["scenarios"]))
               for _ in range(1 if r == 0 else tr["clients"])]
        for cu in cus:
            cu.wait(TIMEOUT_S)
    run.sync()
    run.part("warmup", t0)
    run.records.update(pm=pm, pilot=pilot, points=points, submit=submit,
                       fits=[])


def window(run, deadline: float) -> None:
    tr = run.traffic
    submit = run.records["submit"]
    fits: List[Dict[str, Any]] = run.records["fits"]
    lock = threading.Lock()

    def client(c: int):
        turn = 0
        while time.monotonic() < deadline:
            s, fit_seed = jobs(run, c, turn)
            rec: Dict[str, Any] = {"client": c, "turn": turn, "scenario": s,
                                   "seed": fit_seed,
                                   "t_submit": time.monotonic()}
            cu = submit(s, fit_seed)
            try:
                rec["result"] = cu.wait(TIMEOUT_S)
            except Exception as e:          # a failed CU is counted
                rec["error"] = repr(e)
            rec["t_done"] = time.monotonic()
            rec["overhead_s"] = cu.overhead_s()
            with lock:
                fits.append(rec)
            turn += 1

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(tr["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    run.window_end = max((f["t_done"] for f in fits),
                         default=time.monotonic())
    run.attempted = len(fits)
    run.failed = sum("error" in f for f in fits)
    run.records["pm"].shutdown()


def sample(run) -> List[Dict[str, Any]]:
    """The finished fits the reference redoes: drawn from the seed, with
    every scenario in the sample."""
    done = [f for f in run.records["fits"] if "result" in f]
    rng = random.Random(seeds.derive(run.seed, "check"))
    rng.shuffle(done)
    want = int(run.traffic["check_fits"])
    first = {}
    for f in done:                      # one of each scenario first
        first.setdefault(f["scenario"], f)
    picked = list(first.values())
    taken = {id(f) for f in picked}
    rest = [f for f in done if id(f) not in taken]
    return picked + rest[:max(0, want - len(picked))]


def gaps(run, fits, candidate=None):
    """(cost gap, centroid gap) of each fit against the float64
    reference: |cost - ref| / ref and ||C - C_ref|| / ||C_ref||
    (Frobenius).  The candidate is the program's result, or with
    `candidate` the reference itself at that precision (the control)."""
    from reference import lloyd
    cfg = run.config
    out = []
    for f in fits:
        sc = cfg["scenarios"][f["scenario"]]
        pts = run.records["points"][f["scenario"]]
        args = (pts, sc["clusters"], f["seed"], cfg["iters"])
        c_ref, cost_ref = lloyd.fit(*args, precision="float64")
        cents, cost = (f["result"] if candidate is None
                       else lloyd.fit(*args, precision=candidate))
        c_ref = c_ref.double()
        out.append((abs(cost - cost_ref) / cost_ref,
                    float((cents.double() - c_ref).norm() / c_ref.norm())))
    return out


def summary(g) -> Dict[str, float]:
    return {"cost_gap": max(x for x, _ in g),
            "centroid_gap": max(y for _, y in g)}


def check(run):
    fits = sample(run)
    run.notes["checked"] = fits
    if not fits:
        return [("fits_checked", 0.0, -1.0)]
    lim = run.traffic["limits"]
    return [(k, v, lim[k]) for k, v in summary(gaps(run, fits)).items()]


def control(run, kind: str = "tf32") -> Dict[str, float]:
    """The compared numbers of the reference computed with TF32 products
    (the step below the configuration's float32) in the program's
    place, on the fits the check took."""
    return summary(gaps(run, run.notes["checked"], kind))
