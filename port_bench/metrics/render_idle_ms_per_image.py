"""Device-idle ms a profiled image inside ``pt.render_image`` whose
innermost ``pt.*`` span is not the kernel wrapper's: the render's set-up
and finalize (harness/spans.py)."""

from harness.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "image", "program")
