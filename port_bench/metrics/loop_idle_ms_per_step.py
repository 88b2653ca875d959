"""Device-idle ms a profiled step inside ``pt.step`` whose innermost
``pt.*`` span is not a kernel wrapper's: the chunk loop (start, forward,
cotangent, backward, accumulation) and Adam (harness/spans.py)."""

from harness.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "step", "program")
