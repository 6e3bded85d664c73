"""Median device time, in ms, of one whole ``repro.model.mamba`` span in
the traced slice, forward or remat's recompute: the operations one
layer's Mamba mixer launched, K3 among them."""
from lib import program

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Mamba mixer"
MOVES = "train_tokens_per_s"


def read(run):
    return program.median_ms(run, "model.mamba", device=True)
