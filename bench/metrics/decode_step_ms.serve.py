"""Mean wall of the window's decode steps: the backend's ``step``, which
ends in its device-to-host read of the sampled tokens."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "serving steps, transformer stack"
MOVES = "tpot_p95_ms"


def read(run):
    st = [s.end - s.start for s in run.spans.named("bench.step")
          if s.start >= run.window_start]
    return 1e3 * sum(st) / len(st) if st else None
