"""The readers' shared arithmetic: a kernel's roofline share over the
profiled stretch, and the device's idle share."""

from __future__ import annotations

from . import roofline

# Device rows of each kernel, by the name of its CUDA function.
KERNELS = {
    "k2": r"persistent_render_kernel",
    "k3": r"(?<![A-Za-z0-9_])replay_kernel",
    "k7": r"geometry_replay_kernel",
}


def _launch_work(kernel: str, launch: dict):
    n = launch["n_spheres"]
    if kernel == "k2":
        ops = roofline.render_ops(n, launch["segments"], launch["items"])
        nbytes = roofline.render_bytes(n, launch["items"])
    elif kernel == "k3":
        ops = roofline.render_ops(n, launch["segments"], launch["items"],
                                  prefix_terms=launch["prefix_terms"])
        nbytes = roofline.replay_bytes(n, launch["cells"])
    else:
        ops = roofline.geometry_ops(n, launch["segments"], launch["items"],
                                    launch["sweep_bounces"], launch["missed"],
                                    launch["tied_bounces"])
        nbytes = roofline.geometry_bytes(n, launch["cells"])
    return nbytes, ops.issues()


def roofline_share(ctx, kernel: str):
    """The kernel's bound over its device time in the profiled stretch, in
    %, with a note of what bounds it; None where the stretch ran none of it
    or the reference counted no launch of it."""
    launches = ctx.counts.get(kernel) if ctx.trace is not None else None
    if not launches:
        return None
    seconds = ctx.trace.device_seconds(KERNELS[kernel])
    if seconds <= 0:
        return None
    bound, sides = 0.0, set()
    issues = nbytes = 0
    for launch in launches:
        b, i = _launch_work(kernel, launch)
        ms, side = roofline.bound_ms(b, i)
        bound, issues, nbytes = bound + ms, issues + i, nbytes + b
        sides.add(side)
    note = (f"bound by {' and '.join(sorted(sides))}: {issues:.6e} issues and {nbytes} bytes in "
            f"{len(launches)} launches, {bound:.6f} ms at {roofline.PEAK_FP32_ISSUES_PER_S:.3e} "
            f"issues/s and {roofline.PEAK_BYTES_PER_S:.3e} B/s ({roofline.POWER_LIMIT_W} W), "
            f"against {seconds * 1e3:.6f} ms of device time")
    return {"value": 100.0 * bound / (seconds * 1e3), "note": note}


def idle_pct(ctx, unit: str):
    if ctx.unit != unit or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def rows_per_unit(ctx, unit: str):
    if ctx.unit != unit or ctx.trace is None or not ctx.n_profiled:
        return None
    return ctx.trace.rows() / ctx.n_profiled
