"""K-Means fits finished in the window over the window: from its start
to the end of the last fit that a client submitted before its close."""
UNIT = "fits/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    done = sum("result" in f for f in run.records["fits"])
    return done / run.window_s if run.window_s > 0 else None
