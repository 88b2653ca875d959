"""Device-idle ms a profiled step whose innermost ``pt.*`` span is a kernel
wrapper's (``pt.k2``, ``pt.k3``, ``pt.k7``, ``pt.k7.map``): the card waiting
on the host work around the launches (harness/spans.py)."""

from harness.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "step", "wrapper")
