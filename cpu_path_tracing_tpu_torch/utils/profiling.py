"""Profiler hooks: the counterpart of ``cpu_path_tracing_tpu/utils/profiling.py``.

``maybe_trace`` captures a ``torch.profiler`` trace around any render (a
Chrome trace, viewable in Perfetto or chrome://tracing), ``annotate`` names
a phase of the program in such a trace (the ``pt.*`` spans of the step and
image paths), ``device_time_by_kernel`` sums a profile's device time by
kernel name and ``device_kernel_ms`` lists one kernel's launches in the
order they ran.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def maybe_trace(profile_dir=None):
    """Capture a torch.profiler trace into ``profile_dir`` when given: one
    ``trace_<pid>_<ns>.json`` per use, with the card's activity where there
    is a card.  Yields the profiler (None when off)."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          f"trace_{os.getpid()}_{time.time_ns()}.json"))


# What ``annotate`` returns while no profiler records: one shared object.
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` in the profile being recorded: a
    ``torch.profiler.record_function``, in the same timeline as the card's
    rows, on whichever thread enters it (autograd's device thread too,
    which inherits the caller's profiler state).  While no profiler records
    it is a shared no-op context manager, so that a span on the hot path
    costs one check."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def device_time_by_kernel(prof) -> dict:
    """``{kernel name: (device ms, launches)}`` of a finished profile, from
    its device-side events.  It reads the profiler's raw events: building
    torch's event tree (``key_averages``) took minutes for a profile of
    half a million launches."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            ms, count = out.get(e.name(), (0.0, 0))
            out[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    return out


def device_kernel_ms(prof, name_part: str) -> list:
    """Device ms of every launch of the kernels whose name holds
    ``name_part``, in the order the card started them, from a finished
    profile.  Launches replayed from a CUDA graph are device-side rows like
    any other."""
    rows = [(e.time_range.start, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CPU and name_part in e.name]
    return [ms for _, ms in sorted(rows)]
