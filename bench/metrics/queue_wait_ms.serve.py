"""Median, over the requests due in the window, of the time from when a
request was due to the start of its prefill (the benchmark's span
around the backend's prefill)."""
from lib import stats

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "engine"
MOVES = "ttft_p95_ms"


def read(run):
    w = [r["t_prefill"] - r["due"] for r in run.records["requests"]
         if r.get("t_prefill")]
    return 1e3 * stats.median(w) if w else None
