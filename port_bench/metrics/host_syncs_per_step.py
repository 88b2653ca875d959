"""The CUDA runtime's blocking calls (stream, device and event
synchronizes, the synchronous copy) that start inside the port's
``pt.step`` span, a profiled step: every host read of a device value is
one (harness/spans.py)."""

from harness.spans import syncs_per_unit


def read(ctx):
    return syncs_per_unit(ctx, "step")
