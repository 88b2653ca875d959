"""The share of the traced window in which no kernel, copy or set ran on
the card, on any stream (1 - the union of the device rows / the window),
over the profiled images."""

from harness.shares import idle_pct


def read(ctx):
    return idle_pct(ctx, "image")
