"""The CUDA runtime's blocking calls (stream, device and event
synchronizes, the synchronous copy) that start inside the port's
``pt.render_image`` span, a profiled image: every host read of a device
value is one (harness/spans.py)."""

from harness.spans import syncs_per_unit


def read(ctx):
    return syncs_per_unit(ctx, "image")
