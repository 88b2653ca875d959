"""The whole window over the images it completed, in ms."""

from harness.stats import per_unit_ms


def read(ctx):
    if ctx.unit != "image" or not ctx.completed:
        return None
    return per_unit_ms(ctx.window_s, ctx.completed)
