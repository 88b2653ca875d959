"""One run of one cell: set-up, the measured window, the check, and with
``--trace 1`` a profiled stretch of the window and the per-layer readers.

The result is the last line of standard output; the numbers compared, each
beside its limit, are the last lines of standard error and the last key of
the result."""

from __future__ import annotations

import contextlib
import gc
import json
import math
import resource
import sys
import time
import traceback
from types import SimpleNamespace

import torch

from . import trace as trace_mod
from .stats import percentile

FORBIDDEN = ("jax", "jaxlib", "flax", "cpu_path_tracing_tpu")
MAX_FAILURES_IN_A_ROW = 3


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cards(cell, device) -> list:
    """The cell's cards: ``device`` alone for a one-card cell, else cards 0
    to ``chips`` - 1 of its type."""
    if cell.chips == 1:
        return [device]
    return [torch.device(device.type, k) for k in range(cell.chips)]


def _sync(cards) -> None:
    for device in cards:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def card_held_bytes(device) -> int:
    """The larger of this process's peak on the card and the card's
    device-wide use now, which counts what other processes (the program's
    workers) hold there, and this process's own CUDA context."""
    free, total = torch.cuda.mem_get_info(device)
    return max(torch.cuda.max_memory_allocated(device), total - free)


def memory_peak_bytes(cards) -> int:
    """The fullest card's peak: of a one-card cell, this process's peak on
    its card; of a cell on several, each card's ``card_held_bytes``."""
    if cards[0].type != "cuda":
        return 0
    if len(cards) == 1:
        return torch.cuda.max_memory_allocated(cards[0])
    return max(card_held_bytes(d) for d in cards)


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def window(drv, seconds: float, cards, traced: bool):
    """Run units back to back for ``seconds`` (in a traced run at least until
    the profiled stretch is done).  Returns (unit seconds of the completed
    units, attempted, failed, window seconds, Trace or None, errors), and
    leaves every attempted unit's seconds, in order, in ``drv.unit_seconds``.

    A unit's verdict is True, False, or a callable that is judged once the
    window has closed, so that judging it takes no wait inside the window;
    only a False verdict stops a run early (after some in a row)."""
    profiled = drv.profiled if traced else []
    units, errors = [], []
    in_a_row = 0
    prof = span = trace = None
    t0 = last = time.perf_counter()
    i = 0
    while True:
        if profiled and i == profiled[0]:
            prof = _profiler(cards[0])
            prof.__enter__()
            span = torch.profiler.record_function("pb.window")
            span.__enter__()
        unit = (torch.profiler.record_function(f"pb.{drv.unit}") if span is not None
                else contextlib.nullcontext())
        with unit:
            drv.prepare(i)
            ts = time.perf_counter()
            try:
                out = drv.run(i)
                ok = True
            except Exception:  # a unit that raises is failed, and the run goes on
                errors.append(traceback.format_exc(limit=4))
                ok = False
            te = time.perf_counter()
            verdict = drv.settle(i, out) if ok else False
        last = te
        units.append((te - ts, verdict))
        in_a_row = in_a_row + 1 if verdict is False else 0
        if span is not None and i == profiled[-1]:
            _sync(cards)
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            trace = trace_mod.from_profile(prof, "pb.window")
            span = prof = None
        i += 1
        if in_a_row >= MAX_FAILURES_IN_A_ROW:
            break
        if (time.perf_counter() - t0 >= seconds and (not profiled or trace is not None)
                and i >= drv.min_units):
            break
    drv.unit_seconds = [t for t, _ in units]
    times = [t for t, verdict in units if (verdict() if callable(verdict) else verdict)]
    return times, len(units), len(units) - len(times), last - t0, trace, errors


def cpu_seconds() -> float:
    """This process's CPU seconds, user and system."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def run(cell, seed: int, seconds: float, traced: bool, device, started: float,
        program=None, out=None, err=None, marks=()) -> int:
    """Run ``cell`` (``harness.spec.Cell``) once; ``started`` is the
    process's start on the ``time.perf_counter`` clock.  Returns the exit
    code."""
    out, err = out or sys.stdout, err or sys.stderr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = cell.loop().Cell(cell.config, cell.traffic, seed, device, program)
    drv.cards = cards(cell, device)
    marks = [("interpreter", started), *marks, ("the harness", time.perf_counter())]
    drv.setup()
    _sync(drv.cards)
    marks.append(("the cell's set-up", time.perf_counter()))
    setup_s = time.perf_counter() - started
    cpu0 = cpu_seconds()
    times, attempted, failed, window_s, trace, errors = window(drv, seconds, drv.cards, traced)
    cpu_note = (f"this process on a core {100.0 * (cpu_seconds() - cpu0) / window_s:.1f}% "
                "of the window")
    peak = memory_peak_bytes(drv.cards)
    for e in errors[:3]:
        print(e, file=err)
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = drv.check()
    check_s = time.perf_counter() - t_check
    correct = (attempted > 0 and failed == 0
               and all(_number(v) is not None and v <= lim for _, v, lim in checks))
    t_counts = time.perf_counter()
    counts = drv.counts() if trace is not None else {}
    notes = [f"phases: set-up {setup_s:.3f} s, window {window_s:.3f} s, check {check_s:.3f} s, "
             f"reference counts {time.perf_counter() - t_counts:.3f} s",
             "set-up, s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
             cpu_note]
    if times:
        q = [1e3 * percentile(times, p) for p in (0, 25, 50, 75, 95, 100)]
        notes.append(f"{len(times)} {drv.unit}s, ms at 0/25/50/75/95/100%: "
                     + " ".join(f"{v:.4f}" for v in q))
        tenths = [times[k * len(times) // 10:(k + 1) * len(times) // 10] for k in range(10)]
        notes.append("mean ms by tenth of the window: " + " ".join(
            f"{1e3 * sum(t) / len(t):.3f}" for t in tenths if t))
        halves = [times[:len(times) // 2], times[len(times) // 2:]]
        notes.append("ms at 95% of the window's first half, second half: " + " ".join(
            f"{1e3 * percentile(h, 95):.4f}" for h in halves if h))
    notes += getattr(drv, "notes", [])
    ctx = SimpleNamespace(unit=drv.unit, setup_s=setup_s, window_s=window_s, times=times,
                          completed=len(times), trace=trace, n_profiled=len(drv.profiled),
                          counts=counts)
    metrics = {}
    for m in (cell.per_layer() if traced else cell.end_to_end()):
        got = cell.reader(m)(ctx)
        if isinstance(got, dict):
            notes.append(f"{m['name']}: {got['note']}")
            got = got["value"]
        if got is not None:
            metrics[m["name"]] = {"value": got, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"these modules were loaded in the benchmark's process: {bad}", file=err)
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_s(), trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = {n: {"value": _number(v), "limit": lim} for n, v, lim in checks}
    for line in notes:
        print(line, file=err)
    print(f"{cell.name} seed {seed}: correct={correct} attempted={attempted} failed={failed}",
          file=err)
    for n, v, lim in checks:
        print(f"check {n} = {v!r} (limit {lim!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
