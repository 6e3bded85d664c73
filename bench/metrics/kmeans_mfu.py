"""Percent of the FP32 peak: the assignment work of the window's finished
fits, 2 n k (d + 1) FLOPs an iteration (from the shapes, whatever
implements it), over the window times 67e12 FLOP/s."""
from lib import bounds

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "analytics"
MOVES = "kmeans_fits_per_s"


def read(run):
    cfg = run.config
    flops = 0.0
    for f in run.records["fits"]:
        if "result" in f:
            sc = cfg["scenarios"][f["scenario"]]
            flops += cfg["iters"] * bounds.assign_bound(
                sc["points"], sc["clusters"], cfg["dim"])["flops"]
    if run.window_s <= 0 or not flops:
        return None
    return 100.0 * flops / (run.window_s * bounds.FP32_FLOP_PER_S)
