"""Set-up time: from the process's start to the window's start (imports,
kernel builds and loads, weights or datasets, warm-up)."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
