"""95th percentile of the time to first token over every request due in
the window, each timed from when it was due; a request that failed or
never got its first token is a miss (infinite)."""
import math

from lib import stats

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    reqs = run.records["requests"]
    if not reqs:
        return None
    return 1e3 * stats.percentile(
        [r["t_first"] - r["due"] if r.get("t_first") else math.inf
         for r in reqs], 95)
