"""Median host duration, in ms, of the whole ``repro.data.wait`` spans
in the traced slice: the trainer's wait for its next batch on the token
pipeline's prefetch queue."""
from lib import program

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "data pipeline"
MOVES = "train_tokens_per_s"


def read(run):
    return program.median_ms(run, "data.wait", device=False)
