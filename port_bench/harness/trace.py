"""Reading a ``torch.profiler`` profile of the traced stretch.

The profile's raw events are read (building torch's event tree takes
minutes for a profile of many launches).  Device rows are the kernels,
copies and sets the card ran, on every stream; the card is busy where
any of them runs, so the busy time is the length of the union of their
intervals, clipped to the traced window, and overlapping streams are not
counted twice.  An idle gap is a stretch of the window in which no device
row runs; it is named by the host operation that was running then: of
the host events that overlap it, the shortest among those that cover at
least half of the most any of them covers.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals):
    """Merged, sorted (start, end) pairs of the intervals' union."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(merged, lo, hi):
    """The stretches of [lo, hi) that no merged interval covers."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


@dataclass
class Trace:
    """Device rows and host events (name, start ns, end ns) of a window."""

    window: tuple
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        lo, hi = self.window
        return sum(e - s for s, e in clip(union([(s, e) for _, s, e in self.device]), lo, hi)) / 1e9

    def rows(self) -> int:
        lo, hi = self.window
        return sum(1 for _, s, e in self.device if e > lo and s < hi)

    def device_seconds(self, pattern: str) -> float:
        """Device seconds of the rows whose name matches the regex."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device if rx.search(n)) / 1e9

    def device_ops(self, top: int = 10):
        """[[name, seconds], ...] of the device rows by name, most first."""
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0) + (e - s)
        return [[n[:120], v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def host_at(self, s: int, e: int) -> str:
        best = []
        for n, hs, he in self.host:
            ov = min(e, he) - max(s, hs)
            if ov > 0:
                best.append((ov, he - hs, n))
        if not best:
            return "(no host event)"
        most = max(b[0] for b in best)
        return min((b for b in best if 2 * b[0] >= most), key=lambda b: b[1])[2]

    def idle_gaps(self, top: int = 10):
        """[[host operation, idle seconds], ...]: the window's idle gaps,
        summed by the host operation that was running in each, most first."""
        lo, hi = self.window
        by = {}
        for s, e in gaps(clip(union([(s, e) for _, s, e in self.device]), lo, hi), lo, hi):
            n = self.host_at(s, e)[:120]
            by[n] = by.get(n, 0) + (e - s)
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _device_row(e) -> bool:
    import torch

    if e.device_type() == torch.autograd.DeviceType.CPU:
        return False
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return not e.is_user_annotation()


def from_profile(prof, window_span: str) -> Trace:
    """The Trace of a finished profile whose window is the host span named
    ``window_span``."""
    import torch

    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s, n = e.start_ns(), e.name()
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if n == window_span:
                window = (s, end)
            else:
                host.append((n, s, end))
        elif _device_row(e):
            device.append((n, s, end))
    if window is None:
        raise RuntimeError(f"the profile holds no span {window_span!r}")
    return Trace(window=window, device=device, host=host)
