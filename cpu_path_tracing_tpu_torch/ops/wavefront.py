"""Wavefront renders over a contiguous cell span.

Three entry points, counterparts of ``cpu_path_tracing_tpu/ops/wavefront.py``:

* ``render_wavefront_persistent`` (``render_wavefront_pallas_persistent``,
  ``:374-453``): every (cell, sample) item of the span in one call of the
  whole-render kernel wrapper (the plain version when the scene is on the
  CPU).
* ``render_wavefront`` (the XLA ``render_wavefront``, ``:69-249``): a host
  loop of the plain step, ``megakernel_step_reference``, in the scene's
  dtype on any device, float64 and tent jitter included.
* ``render_wavefront_per_step`` (``render_wavefront_pallas``,
  ``:252-371``): the same loop over launches of the per-step kernel, a few
  iterations each, a batch of launches replayed as one CUDA graph (the
  plain step, launch by launch, when the scene is on the CPU).

The two loops share one host loop: a pool of ``B = min(lanes or
cfg.wavefront_lanes, n_items)`` lanes, item = gen * B + lane, cell =
min(cell_start + item % n_cells, cells - 1).  The JAX loops retire results
into a K-slot ring flushed at a watermark, because TPU scatter is slow
(``:19-27``); here a finished path writes ``out[:, item]`` directly, so no
lane ever stalls and the loop ends at the first step in which no lane was
alive after regeneration.  So ``iters`` (steps with live lanes) differs
from the JAX loops' count, which includes ring stalls and flushes; per-item
radiance depends only on (seed, cell, sample) through the item keys
(ops/rng.py), so results and ``segments`` do not depend on the schedule.

Every path sums each cell's samples in sample order, the association order
of the JAX package's per-cell reduction (``:237-243``).
"""

from __future__ import annotations

import functools

import torch

from ..config import RenderConfig
from ..utils.profiling import annotate
from .kernels.megakernel import (
    cell_span,
    init_lane_state,
    megakernel_step,
    megakernel_step_batch,
    megakernel_step_reference,
    pack_camera,
    pack_scene,
    persistent_render,
)

# Launches between two reads of the live counts: the loop syncs with the
# device once per batch, and a step on a drained pool adds 0.
STEP_BATCH = 16
# Steps one launch of the per-step kernel runs with the path in registers
# (PERF.md, Findings: measured at 1, 2, 4, 8, 16 and 32).
STEPS_PER_LAUNCH = 8


def _cell_sums(out, num_samples: int, n_cells: int):
    """Per-item radiance [3, num_samples * n_cells] -> per-cell sums
    [n_cells, 3], adding samples in sequence."""
    per_sample = out.view(3, num_samples, n_cells)
    sums = per_sample[:, 0].clone()
    for i in range(1, num_samples):
        sums += per_sample[:, i]
    return sums.T.contiguous()


def render_wavefront_persistent(scene, cfg: RenderConfig, cell_ids, sample_start: int,
                                num_samples: int, *, with_stats: bool = False):
    """SUM of radiance over samples [sample_start, sample_start+num_samples)
    for each cell of ``cell_ids``, a contiguous ascending span: a host
    ``range``, or an id tensor, which alone is read back from its device
    (``ops/kernels/megakernel.cell_span``).  Returns [n_cells, 3] in the
    scene's dtype, plus ``{segments, iters, lanes}`` when asked
    (ops/kernels/megakernel.py defines them)."""
    with annotate("pt.k2"):
        cell_start, n_cells = cell_span(cell_ids)
        dtype = scene.dtype
        table = pack_scene(scene, dtype)
        cam = pack_camera(scene, dtype)
        out, stats = persistent_render(table, cam, (cell_start, sample_start), cfg=cfg,
                                       n_cells=n_cells, n_items=n_cells * num_samples,
                                       ior=scene.ior)
        sums = _cell_sums(out, num_samples, n_cells)
    if with_stats:
        return sums, stats
    return sums


def drive_items(step, scene, cfg: RenderConfig, cell_ids, sample_start: int,
                num_samples: int, lanes: int | None = None):
    """The per-step loop: ``step`` (``megakernel_step`` or its plain
    version) over the span until the pool drains, in batches of
    ``STEP_BATCH`` launches of ``STEPS_PER_LAUNCH`` steps.  After each batch
    the host reads its live counts and stops when the last step found no
    lane alive.  With ``megakernel_step`` on a CUDA scene a batch is one
    replay of a CUDA graph (``megakernel_step_batch``); any other ``step``,
    and any scene on the CPU, runs launch by launch.  Returns per-item
    radiance (out [3, n_items], item = sample * n_cells + c) and the stats
    ``{segments, iters, lanes}``.  ``cell_ids`` as ``cell_span`` takes it."""
    cell_start, n_cells = cell_span(cell_ids)
    n_items = n_cells * num_samples
    dtype, device = scene.dtype, scene.device
    B = max(1, min(lanes or cfg.wavefront_lanes, n_items))
    out = torch.empty((3, n_items), dtype=dtype, device=device)
    if not n_items:
        return out, {"segments": 0, "iters": 0, "lanes": B}
    n_gens = -(-n_items // B)
    # Each lane runs at most n_gens paths of at most max_depth bounces, and
    # starts its next path in the step that ends the last: one more step
    # finds the pool drained.
    cap = n_gens * cfg.max_depth + 1
    S = STEPS_PER_LAUNCH
    seg = torch.zeros(STEP_BATCH * S, dtype=torch.int64, device=device)
    table, cam = pack_scene(scene, dtype), pack_camera(scene, dtype)
    state = init_lane_state(B, device, dtype)
    dyn = (cell_start, sample_start)
    kw = dict(cfg=cfg, n_cells=n_cells, n_items=n_items, lanes=B, out=out, seg=seg, steps=S,
              ior=scene.ior)

    def run_batch():
        seg.zero_()
        for b in range(STEP_BATCH):
            step(state, table, cam, dyn, seg_slot=b * S, **kw)

    replay = None
    counts = []
    while True:
        if step is not megakernel_step or device.type != "cuda":
            run_batch()
        elif replay is None:  # runs the first batch, captures the rest
            replay = megakernel_step_batch(state, table, cam, dyn, batch=STEP_BATCH, **kw)
        else:
            replay()
        counts += seg.tolist()  # the one sync of the batch
        if counts[-1] == 0:
            break
        if len(counts) >= cap:
            raise RuntimeError(f"the wavefront loop did not drain in {cap} steps "
                               f"(n_gens={n_gens}, max_depth={cfg.max_depth})")
    return out, {"segments": sum(counts), "iters": sum(c > 0 for c in counts), "lanes": B}


def render_wavefront(scene, cfg: RenderConfig, cell_ids, sample_start: int,
                     num_samples: int, *, lanes: int | None = None, with_stats: bool = False,
                     depth_hist: bool = False):
    """SUM of radiance over the sample range for each cell of a contiguous
    span ([n_cells, 3], the scene's dtype), by the plain step on the
    scene's device.  Stats: ``segments`` (path segments, int), ``iters``
    (steps with live lanes; not the JAX loop's count, see the module
    docstring) and ``lanes`` (B), so ``segments / (iters * lanes)`` is the
    pool's occupancy.  With ``depth_hist`` also ``depth_hist``: [max_depth]
    int64, the items retired after exactly d+1 segments."""
    hist = None
    if depth_hist:
        hist = torch.zeros(cfg.max_depth, dtype=torch.int64, device=scene.device)
    step = functools.partial(megakernel_step_reference, hist=hist)
    out, stats = drive_items(step, scene, cfg, cell_ids, sample_start, num_samples, lanes)
    sums = _cell_sums(out, num_samples, len(cell_ids))
    if not with_stats:
        return sums
    if depth_hist:
        stats["depth_hist"] = hist
    return sums, stats


def render_wavefront_per_step(scene, cfg: RenderConfig, cell_ids, sample_start: int,
                              num_samples: int, *, lanes: int | None = None,
                              with_stats: bool = False):
    """``render_wavefront`` through ``megakernel_step``: on a CUDA scene the
    per-step kernel (float32, uniform jitter, or ValueError), on a CPU
    scene its plain version."""
    out, stats = drive_items(megakernel_step, scene, cfg, cell_ids, sample_start, num_samples,
                        lanes)
    sums = _cell_sums(out, num_samples, len(cell_ids))
    if with_stats:
        return sums, stats
    return sums
