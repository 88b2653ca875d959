"""The whole window over the steps it completed, in ms."""

from harness.stats import per_unit_ms


def read(ctx):
    if ctx.unit != "step" or not ctx.completed:
        return None
    return per_unit_ms(ctx.window_s, ctx.completed)
