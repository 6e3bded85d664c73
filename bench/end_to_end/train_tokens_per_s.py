"""Training tokens per second: the tokens of every step run whole in the
window, over the time from the window's start to the end of its last
step."""
UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    steps = run.records["steps"]
    if not steps or run.window_s <= 0:
        return None
    return sum(s["tokens"] for s in steps) / run.window_s
