"""Percent: ``scan_bound`` of each K3 launch in the traced slice (a
microbatch: rows, sequence, d_inner, state) over K3's device time."""
from lib import bounds, readers

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_tokens_per_s"
K3 = "mamba_scan_kernel"


def read(run):
    c, (rows, seq) = run.config, run.records["microbatch"]
    b = bounds.scan_bound(rows, seq, c["ssm_expand"] * c["d_model"],
                          c["ssm_d_state"])["seconds"]
    return readers.roofline(run, (K3,), K3, lambda attrs: b)
