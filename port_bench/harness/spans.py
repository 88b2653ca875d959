"""The port's own spans in the traced stretch: its host syncs and the
device's idle time, each given to the program's layer that holds it.

The port names its phases with ``pt.*`` spans (``utils/profiling.annotate``
in ``cpu_path_tracing_tpu_torch``), which a recording profiler keeps in the
same timeline as the card's rows.  A unit's top span is ``pt.step`` (a fit's
step) or ``pt.render_image`` (an image); the loops are closed, so one unit
runs at a time and every ``pt.*`` span of a unit lies inside its top span,
on whichever thread (autograd runs a step's backward on its device thread).
A stretch of time belongs to its innermost ``pt.*`` span: the shortest that
covers it, on any thread; time under no ``pt.*`` span is the harness's
(the wait after an image, ``float(loss)`` after a step, preparing a unit).

* Host syncs: the CUDA runtime's blocking calls (``SYNC``) that start inside
  a top span, whatever host read issued them: every ``int(tensor)``,
  ``bool(tensor)`` or ``.item()`` is one ``cudaMemcpyAsync`` and one
  ``cudaStreamSynchronize``.
* Idle split: the window's idle time (no device row running, as
  ``Trace.busy_s`` takes it), cut at the spans' edges, each piece given to
  its innermost span.  The parts add up to the idle time by construction.

A trace with no top span (a program without the spans) reads None.
"""

from __future__ import annotations

import re

from .trace import clip, gaps, union

PREFIX = "pt."
TOP = {"step": "pt.step", "image": "pt.render_image"}
# The kernel wrappers' spans: the launch with its checks, read-backs, packs
# and the reductions around it.
WRAPPERS = ("pt.k2", "pt.k3", "pt.k7", "pt.k7.map")
# Blocking calls of the CUDA runtime and their driver-API twins.
SYNC = re.compile(r"^(cuda(Stream|Device|Event)Synchronize|cudaMemcpy|"
                  r"cu(Stream|Ctx|Event)Synchronize|cuMemcpy(DtoH|HtoD)?(_v2)?)$")


def program_spans(trace):
    """(start ns, end ns, name) of the window's ``pt.*`` spans."""
    lo, hi = trace.window
    return [(s, e, n) for n, s, e in trace.host if n.startswith(PREFIX) and e > lo and s < hi]


def innermost(spans, s: int, e: int):
    """The name of the shortest span that covers [s, e), or None."""
    cover = [(se - ss, n) for ss, se, n in spans if ss <= s and e <= se]
    return min(cover)[1] if cover else None


def _has_top(ctx, unit: str) -> bool:
    return (ctx.unit == unit and ctx.trace is not None and bool(ctx.n_profiled)
            and any(n == TOP[unit] for n, _, _ in ctx.trace.host))


def _ranked(by: dict, scale: float, fmt: str) -> str:
    return ", ".join(f"{n} {fmt.format(v * scale)}"
                     for n, v in sorted(by.items(), key=lambda kv: (-kv[1], kv[0])))


def syncs_per_unit(ctx, unit: str):
    """The CUDA runtime's blocking calls a profiled unit that start inside
    its top span, with a note of their count by innermost span; None where
    the trace holds no top span of ``unit``."""
    if not _has_top(ctx, unit):
        return None
    spans = program_spans(ctx.trace)
    tops = [(s, e) for s, e, n in spans if n == TOP[unit]]
    calls = [s for n, s, _ in ctx.trace.host if SYNC.match(n)]
    by = {}
    for c in calls:
        if any(s <= c < e for s, e in tops):
            name = innermost(spans, c, c)
            by[name] = by.get(name, 0) + 1
    n = ctx.n_profiled
    note = (f"{sum(by.values())} in {len(tops)} {TOP[unit]} spans of {n} profiled {unit}s "
            f"({len(calls)} in the window); a {unit} by innermost span: "
            f"{_ranked(by, 1.0 / n, '{:g}') or 'none'}")
    return {"value": sum(by.values()) / n, "note": note}


def idle_by_span(trace) -> dict:
    """{innermost ``pt.*`` span name, or None for the harness: idle ns} of
    the traced window."""
    lo, hi = trace.window
    idle = gaps(clip(union([(s, e) for _, s, e in trace.device]), lo, hi), lo, hi)
    spans = program_spans(trace)
    cuts = sorted({lo, hi, *(min(max(x, lo), hi) for s, e, _ in spans for x in (s, e))})
    owner = [innermost(spans, a, b) for a, b in zip(cuts, cuts[1:])]
    out, k = {}, 0
    for gs, ge in idle:
        while cuts[k + 1] <= gs:
            k += 1
        j = k
        while j < len(owner) and cuts[j] < ge:
            piece = min(ge, cuts[j + 1]) - max(gs, cuts[j])
            if piece > 0:
                out[owner[j]] = out.get(owner[j], 0) + piece
            j += 1
    return out


def idle_ms_per_unit(ctx, unit: str, part: str):
    """Device-idle ms a profiled unit whose innermost ``pt.*`` span is a
    kernel wrapper's (``part`` 'wrapper') or another of the program's
    (``part`` 'program': the chunk loop and Adam, or the render's host
    path), with a note of the split by span, the harness's idle ms a unit
    and the parts' sum against the window's idle ms a unit; None where the
    trace holds no top span of ``unit``, or no wrapper span for 'wrapper'."""
    if not _has_top(ctx, unit):
        return None
    if part == "wrapper" and not any(n in WRAPPERS for n, _, _ in ctx.trace.host):
        return None
    by = idle_by_span(ctx.trace)
    mine = {n: v for n, v in by.items()
            if n is not None and (n in WRAPPERS) == (part == "wrapper")}
    per = 1e-6 / ctx.n_profiled
    wrapper = sum(v for n, v in by.items() if n in WRAPPERS) * per
    program = sum(v for n, v in by.items() if n is not None and n not in WRAPPERS) * per
    harness = by.get(None, 0) * per
    idle = (ctx.trace.window_s - ctx.trace.busy_s()) * 1e3 / ctx.n_profiled
    note = (f"{_ranked(mine, per, '{:.4f}') or 'none'} ms a {unit}; idle ms a {unit}: wrappers "
            f"{wrapper:.4f} + program {program:.4f} + harness {harness:.4f} = "
            f"{wrapper + program + harness:.4f} of {idle:.4f} in the window")
    return {"value": sum(mine.values()) * per, "note": note}
