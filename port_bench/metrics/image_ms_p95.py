"""The 95th percentile of every completed image's time in the window (host
clock, from the call to the wait that ends it), in ms."""

from harness.stats import percentile


def read(ctx):
    if ctx.unit != "image" or not ctx.completed:
        return None
    return 1e3 * percentile(ctx.times, 95)
