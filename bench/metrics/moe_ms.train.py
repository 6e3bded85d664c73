"""Median device time, in ms, of one whole ``repro.model.moe`` span in
the traced slice, forward or remat's recompute: the operations one MoE
sublayer launched, its own and those of the spans inside it on its
thread (``.route``, ``.dispatch``, ``.experts``, ``.combine``)."""
import statistics

from lib import program

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "MoE layer"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    subs = [i for name, insts in program.instances(tr).items()
            if name.startswith(program.PREFIX + "model.moe.") for i in insts]
    got = []
    for top in program.whole(tr, "model.moe"):
        inner = [i for i in subs if i.span.thread == top.span.thread
                 and top.span.start <= i.span.start
                 and i.span.end <= top.span.end]
        ops = [e for i in inner for e in i.ops]
        if all(tr.start <= e.start and e.end <= tr.end for e in ops):
            got.append(top.device_s + sum(e.end - e.start for e in ops))
    return 1e3 * statistics.median(got) if got else None
