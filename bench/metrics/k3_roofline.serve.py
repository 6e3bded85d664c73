"""Percent: ``scan_bound`` of each K3 launch of a prefill in the traced
slice (one row of the prefill's bucket) over K3's device time."""
from lib import bounds, readers

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "ttft_p95_ms"
K3 = "mamba_scan_kernel"


def read(run):
    c = run.config
    di, st = c["ssm_expand"] * c["d_model"], c["ssm_d_state"]

    def bound_of(attrs):
        if attrs.get("") != "bench.prefill":
            return None
        return bounds.scan_bound(1, int(attrs["bucket"]), di, st)["seconds"]
    return readers.roofline(run, (K3,), K3, bound_of)
