"""Median, over the whole ``repro.train.optimizer`` spans in the traced
slice, of the summed device time of the operations each launched, in
ms: one AdamW step with its global gradient norm."""
from lib import program

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "optimizer"
MOVES = "train_tokens_per_s"


def read(run):
    return program.median_ms(run, "train.optimizer", device=True)
