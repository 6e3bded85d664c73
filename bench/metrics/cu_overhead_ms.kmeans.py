"""Median, over the window's K-Means CUs, of the Pilot core's overhead:
``ComputeUnit.overhead_s()``, from queued (t_pending) to running."""
from lib import stats

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Pilot core"
MOVES = "kmeans_fits_per_s"


def read(run):
    o = [f["overhead_s"] for f in run.records["fits"]
         if f.get("overhead_s") is not None]
    return 1e3 * stats.median(o) if o else None
