"""Percent of the bf16 tensor-core peak: the model FLOPs of the window's
steps (``moe_bounds.train_flops``: 6 N_active a token plus causal
attention) over the window times 989e12 FLOP/s."""
from lib import bounds, moe_bounds

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "trainer, step, optimizer"
MOVES = "train_tokens_per_s"


def read(run):
    tokens = sum(s["tokens"] for s in run.records["steps"])
    if run.window_s <= 0 or not tokens:
        return None
    seq = run.records["microbatch"][1]
    return 100.0 * moe_bounds.train_flops(run.config, tokens, seq) / (
        run.window_s * bounds.BF16_TC_FLOP_PER_S)
