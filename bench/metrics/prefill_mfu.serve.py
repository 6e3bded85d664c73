"""Percent of the bf16 tensor-core peak: 2 N (real prompt tokens, not the
bucket's padding) over the summed wall of the window's prefill calls
times 989e12 FLOP/s."""
from lib import bounds

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "serving steps, transformer stack"
MOVES = "ttft_p95_ms"


def read(run):
    pre = [s for s in run.spans.named("bench.prefill")
           if s.start >= run.window_start]
    wall = sum(s.end - s.start for s in pre)
    tokens = sum(int(s.attrs["tokens"]) for s in pre)
    if wall <= 0:
        return None
    return 100.0 * bounds.prefill_flops(run.config, tokens) / (
        wall * bounds.BF16_TC_FLOP_PER_S)
