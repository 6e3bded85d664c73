"""Percent: ``ssm_bwd_bound`` (the work the scan's backward needs, once)
of each launch of the fused Mamba backward in the traced slice over its
device time (the walk kernel and its sum kernel)."""
from lib import bounds, readers

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_tokens_per_s"
WALK, SUM = "mamba_ssm_bwd_kernel", "mamba_ssm_bwd_sum_kernel"


def read(run):
    c, (rows, seq) = run.config, run.records["microbatch"]
    b = bounds.ssm_bwd_bound(rows, seq, c["ssm_expand"] * c["d_model"],
                             c["ssm_d_state"])["seconds"]
    return readers.roofline(run, (WALK, SUM), WALK, lambda attrs: b)
