"""Percent: ``assign_bound`` of each K1 scan launch in the traced slice
over K1's device time, scan and merge.  A launch takes its fit's
scenario from the span that launched it; one the trace does not tie to
a span (its fit began before the slice, or fits on other threads were
open too) takes the least of the scenarios' bounds, so the share never
reads high.  The paper's scenarios have one n k, so their bounds differ
by 3e-5 of themselves."""
from lib import bounds, readers

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "kmeans_fits_per_s"
SCAN, MERGE = "kmeans_assign_kernel", "kmeans_merge_kernel"


def read(run):
    cfg = run.config

    def bound(sc):
        return bounds.assign_bound(sc["points"], sc["clusters"],
                                   cfg["dim"])["seconds"]
    least = min(bound(sc) for sc in cfg["scenarios"])

    def bound_of(attrs):
        if attrs.get("") != "bench.fit":
            return least
        return bound(cfg["scenarios"][int(attrs["scenario"])])
    return readers.roofline(run, (SCAN, MERGE), SCAN, bound_of)
