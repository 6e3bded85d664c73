"""Percent of the traced slice's busy time (``Trace.busy_s``) in which
an operation launched inside a ``recompute=1`` span ran: remat's second
forward of each layer inside backward, as a union of device intervals
over the slice."""
from lib import program, stats

UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "remat"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ops = [e for insts in program.instances(tr).values() for i in insts
           if i.attrs.get("recompute") == "1" for e in i.ops]
    busy = tr.busy_s()
    if not ops or busy <= 0:
        return None
    return 100.0 * stats.covered(((e.start, e.end) for e in ops),
                                 tr.start, tr.end) / busy
