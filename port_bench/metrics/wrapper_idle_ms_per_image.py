"""Device-idle ms a profiled image whose innermost ``pt.*`` span is the
render kernel's wrapper (``pt.k2``): the card waiting on the host work
around the launch (harness/spans.py)."""

from harness.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "image", "wrapper")
