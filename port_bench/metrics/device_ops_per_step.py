"""Device rows (kernels, copies, sets) the card ran a profiled step."""

from harness.shares import rows_per_unit


def read(ctx):
    return rows_per_unit(ctx, "step")
