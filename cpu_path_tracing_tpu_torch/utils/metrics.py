"""Metrics, logging and the render report.

Counterpart of ``cpu_path_tracing_tpu/utils/metrics.py``: ``RenderReport``
(the same fields, properties and JSON line, plus ``device``: the card's
name or "cpu", so that a time is never read without the device it was
taken on), ``ProgressLogger`` (the reference's stderr progress line,
``src/main.cpp:219-220``), ``MetricsSink`` (structured records, echoed as
JSON lines) and ``Timer`` (host clock; on the card, time what ends in a
synchronize).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from typing import List, Optional


@dataclasses.dataclass
class RenderReport:
    scene: str
    width: int
    height: int
    total_spp: int
    seconds: float
    segments: int
    camera_rays: int
    # Wavefront observability: loop iterations x lane count give live-lane
    # occupancy; depth_hist[d] counts paths retired after exactly d+1
    # segments.  0/None when the integrator does not report them.
    iters: int = 0
    lanes: int = 0
    depth_hist: Optional[List[int]] = None
    device: str = ""

    @property
    def mrays_per_s(self) -> float:
        return self.segments / self.seconds / 1e6 if self.seconds else 0.0

    @property
    def avg_depth(self) -> float:
        return self.segments / self.camera_rays if self.camera_rays else 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of lanes tracing a live path per loop iteration."""
        denom = self.iters * self.lanes
        return self.segments / denom if denom else 0.0

    def depth_percentiles(self, qs=(0.5, 0.9, 0.99)) -> Optional[dict]:
        """Path-length percentiles from the retirement histogram."""
        if not self.depth_hist:
            return None
        total = sum(self.depth_hist)
        if not total:
            return None
        out, acc, it = {}, 0, iter(enumerate(self.depth_hist, start=1))
        d, c = next(it)
        for q in sorted(qs):
            goal = q * total
            while acc + c < goal:
                acc += c
                d, c = next(it)
            out[f"p{int(q * 100)}"] = d
        return out

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["mrays_per_s"] = round(self.mrays_per_s, 3)
        d["avg_depth"] = round(self.avg_depth, 3)
        if self.iters:
            d["occupancy"] = round(self.occupancy, 4)
        pct = self.depth_percentiles()
        if pct:
            d["depth_percentiles"] = pct
        return json.dumps(d)

    def summary(self) -> str:
        s = (f"{self.scene} {self.width}x{self.height}@{self.total_spp}spp: "
             f"{self.seconds:.2f}s, {self.segments / 1e6:.1f}M rays, "
             f"{self.mrays_per_s:.1f} Mrays/s, avg depth {self.avg_depth:.1f}")
        if self.iters:
            s += f", occupancy {100 * self.occupancy:.1f}%"
        pct = self.depth_percentiles()
        if pct:
            s += " (path-length " + " ".join(f"{k}={v}" for k, v in pct.items()) + ")"
        return s


def device_label(device) -> str:
    """The device a number was taken on: for a CUDA device the card's name
    and its power limit as ``nvidia-smi`` reads it (a card below its
    maximum runs slower under load), else the device's own name."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        limit = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return f"{torch.cuda.get_device_name(index)}, power limit {limit}"


class ProgressLogger:
    """The reference's '\\rRendering (N spp) xx.xx%' stderr line
    (``src/main.cpp:219-220``), one update per batch or tile."""

    def __init__(self, total_spp: int, stream=None):
        self.total_spp = total_spp
        self.stream = stream if stream is not None else sys.stderr
        self.t0 = time.perf_counter()

    def __call__(self, done: int, total: int) -> None:
        pct = 100.0 * done / total
        dt = time.perf_counter() - self.t0
        print(f"\rRendering ({self.total_spp} spp) {pct:5.1f}%  [{dt:.1f}s]", end="",
              file=self.stream, flush=True)
        if done >= total:
            print(file=self.stream)


class MetricsSink:
    """Collects metric records; optionally mirrors each to stdout as a JSON line."""

    def __init__(self, echo: bool = False):
        self.records: List[dict] = []
        self.echo = echo

    def log(self, **kv) -> None:
        kv.setdefault("t", time.time())
        self.records.append(kv)
        if self.echo:
            print(json.dumps(kv), flush=True)


class Timer:
    """Host-clock seconds of a ``with`` block (``.seconds``)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False
