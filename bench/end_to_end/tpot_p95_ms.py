"""95th percentile, over every completed request due in the window with
two tokens or more, of (last token - first token) / (tokens - 1)."""
from lib import stats

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    tpot = [(r["t_done"] - r["t_first"]) / (r["n_out"] - 1)
            for r in run.records["requests"]
            if r.get("t_done") and r["n_out"] >= 2]
    return 1e3 * stats.percentile(tpot, 95) if tpot else None
