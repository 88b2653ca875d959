"""Device rows (kernels, copies, sets) the card ran a profiled image."""

from harness.shares import rows_per_unit


def read(ctx):
    return rows_per_unit(ctx, "image")
