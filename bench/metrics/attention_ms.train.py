"""Median device time, in ms, of one whole ``repro.model.attention``
span in the traced slice, forward or remat's recompute: the operations
one layer's attention sublayer launched."""
from lib import program

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "attention"
MOVES = "train_tokens_per_s"


def read(run):
    return program.median_ms(run, "model.attention", device=True)
