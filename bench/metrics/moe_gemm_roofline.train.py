"""Percent: the least time of each grouped-GEMM launch in the traced
slice (the device kernels named with ``moe_bounds.GROUPED_GEMM``, each
``moe_bounds.product_bound`` at the rows a MoE call computed on average
over the window, from the program's counter) over the device time of
those launches."""
from lib import moe_bounds

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_tokens_per_s"


def read(run):
    moe = run.records.get("moe")
    if run.trace is None or not moe:
        return None
    b = moe_bounds.product_bound(run.config, moe["rows_per_call"])
    spent = [e.end - e.start
             for e, _ in run.trace.kernels(moe_bounds.GROUPED_GEMM)]
    return 100.0 * len(spent) * b["seconds"] / sum(spent) if spent else None
