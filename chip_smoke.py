#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cpu_path_tracing_tpu_torch/csrc`` and
drives the forward render and the inverse-rendering step the way a user
does.  Each phase prints one JSON line; any failed check raises, so the
script exits non-zero.

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: nvcc seconds, each kernel's registers, stack and spills (no
   spill in the whole-render kernel, none in the replay kernel's buckets of
   8 and 16 spheres), and from the SASS the loop of each probe op as the
   probe runs it: its instructions, the arithmetic instruction that shows
   the loop was neither folded nor hoisted, and what one trip issues on the
   fast path, by pipe (``fast_path``).
3. kernel_vs_plain: for every registered scene at 64x48, 2 spp, the
   kernel's per-item radiance against its plain PyTorch version on the card:
   bitwise equal at max_depth 8 and 100 (the tier-1 and tier-2 figures the
   per-step kernel is held to are reported beside it).  Then kernel_regen:
   launches of more items than the kernel has threads, so each thread starts
   further items, at a nonzero cell_start and sample_start (one through
   ``render_cells_range``, one over a span that runs past the last cell),
   a span whose item count is no multiple of 32, one of fewer items than a
   warp has lanes, and one whose cells lie past 2^31 (the 64-bit kernel),
   bitwise at max_depth 100.
4. pins: ``render_image`` on the card against the committed JAX renders
   ``tests/data/pin_*_64x48.npz`` (2 spp, max_depth 16): at most 1% of
   pixels above 1e-4 scale-aware, channel means within 1%.
5. main_path: ``render_image`` of disco_sphere (box_mirror) at 1024x768,
   32 total spp, max_depth 100, with the kernel's launch count; then
   ``render_cells_range`` and the kernel alone timed with CUDA events
   (1 warm-up, median of 3), the plain version once at the same size, and
   the kernel held to it on all 25,165,824 items bitwise.
   "Rays" are path segments (live paths summed over bounces).
6. replay_vs_plain: the replay kernel's ``[7N+6]`` gradient partials against
   its plain version (float64 accumulation) on the card, for every scene
   of at most 40 spheres at 64x48, 2 spp, max_depth 8 and 100, with a
   seeded normal cotangent: segments equal, each block (cq, rr_w, ge, gbg)
   within 1e-4 of its largest magnitude + 1e-7.  Then two regenerating
   launches on box 400x400 at nonzero cell_start and sample_start (one past
   the last cell), two launches bitwise equal, and random_spheres (100
   spheres) rejected with ValueError.
7. train_path: the production inverse step (box 400x400, 64 total spp,
   max_depth 100, albedo and emission from +0.02, Adam lr 1e-2, 131,072-cell
   chunks: 5 per step): one warm-up step and 5 steps timed with CUDA
   events; steps/s, 5 replay launches per step, the loss each step (finite
   and falling), the forward and replay kernel ms on the first full chunk,
   and both kernels against their plain versions there: the forward
   bitwise on all 2,097,152 items, the replay by the block limits above with
   the step's own cotangent, and two replay launches bitwise equal.

8. step_vs_plain and step_vs_persistent: for every registered scene at
   64x48, 2 spp, the per-step kernel's per-item radiance (the per-step
   loop, ``ops/wavefront.drive_items``: batches of launches of a few steps
   each, replayed as one CUDA graph) against the plain step on the card
   by tier 1 (max_depth 8) and tier 2 (max_depth 100), and against the
   whole-render kernel bitwise, with equal segment counts.
9. step_regen: per-step loops of 65,536 lanes over more items, so lanes
   start several items, at a nonzero cell_start and sample_start (one also
   through ``render_cells_range``, one over a span past the last cell):
   bitwise equal to the whole-render kernel, tier 1 against the plain step.
   Then step_steps: on the first of those spans, one launch of S steps (S =
   2, 8, 32) against S launches of one step, launch after launch to past
   the drain: the lane state, ``out`` and every count bitwise.
10. bench_path: the per-step slice at full size, ``cli bench --scene
   box_mirror --total-spp 32`` (on the card by default; 1024x768, max_depth 100, a
   pool of 524,288 lanes; one warm-up and 3 timed runs): its RenderReport,
   the per-step kernel's launches, the steps a launch runs, the kernel's
   own time (device rows of torch.profiler over one graph-driven render)
   per render and per launch, the card's idle share in that window (the
   profiler slows the host) and against ``cli bench``'s untraced time, the
   lane-state bytes the design moves (counted in a launch-by-launch render,
   which must equal the graph-driven one bitwise) and their floor at the
   card's memory rate; then all 25,165,824 items held to the whole-render
   kernel bitwise and to the plain step (run once, timed) by tier 1.
11. wavefront_route: a float64 scene and tent-jitter scenes on the card
   through integrator 'auto': ``resolve_integrator`` gives 'wavefront', no
   kernel launches, and the card's per-cell sums agree with the CPU's
   (1e-9 relative in float64; tier 1 in float32).

12. probe_vs_plain: the probe kernels against their plain versions on the
   card.  The op-chain kernel, every op at n = 64*128 and at the probe's
   full width (1,081,344 elements), 16 iterations and the op's own count,
   on seeded inputs: the uint32 round and Threefry bitwise (int64 words
   and int32 bits), mul-add, add and select bitwise, the fused
   multiply-add within 1 ulp, sin, sqrt and 1/sqrt within 2 ulp, with the
   largest ulp distance seen and each plain version's time at full width.
   The stream kernel at 2^26, at 2^20 + 3, below one tile (1,000) and
   below one float4 (3 elements), bitwise.  Both launch counts checked.
13. probe_path: the machine-constant probe, ``scripts/torch_perf_probe.py``'s
   ``probe()`` in process: its constants, the SM clock under load, each
   rate's share of the card's published peak (an application charged the
   function's operations by ``utils/roofline.CHAIN_OPS``, no loop
   control), the stream kernel's GB/s beside ``torch.mul`` on the same
   tensors.  Every rate finite and positive, no share above 100%.

14. geometry_replay_vs_plain: the geometry replay kernel's ``[4N+14]``
   partials (p0, radius, camera) against its plain version (the same
   float32 decisions, float64 adjoints) on the card, for every scene of at
   most 40 spheres at 64x48, 2 spp, max_depth 8 and 100, with a seeded
   normal cotangent: segments, swept paths and swept bounces equal, each
   block within 1e-4 of its largest magnitude + 1e-7, two launches bitwise
   equal.  The same on simple with every sphere twice and with its right
   sphere three times (roots that tie exactly: t's adjoint split among
   them), the tied bounces swept more than 0 and equal to the plain
   version's.  Then two regenerating launches on simple 400x400 at nonzero
   cell_start and sample_start (one past the last cell), and the scenes of
   more than 40 spheres on the 'scan' route (random_spheres: a p0, radius
   and camera step on the card with no geometry replay launch).
15. geometry_grad: the scan VJP (the 'scan' route) on the card against the
   CPU's, float64, simple and box at 64x48, 2 spp, max_depth 100, every
   field of ``grad.OPTIMIZABLE`` (the camera's eight leaves each): within
   1e-9 of each field's largest magnitude, box's p0 and radius gradients
   exactly 0.  Float32 (simple, ``replay=False``): two backward passes
   bitwise equal and finite, and the backward's recomputed radiance (the
   batch route) against the forward kernel's per-item radiance by tier 1.
   Each record carries the seconds its CPU and card parts took.
16. geometry_path: ``cli invert --scene simple --width 400 --height 400
   --total-spp 64 --max-depth 100 --fields p0,radius,albedo,camera --steps
   3`` on the card by default, uncut: the 'geometry' route, 5 forward, 5
   replay and 5 geometry replay launches a step (and 5 forward for the
   target), no scan VJP and no ``torch.utils.checkpoint`` recompute, the
   loss each step (finite), steps/s, peak device memory; the same step as
   the CLI builds it, 3 CUDA-event-timed steps after a warm-up and one
   under ``torch.profiler`` (busy share, launches); then the geometry
   replay kernel on the step's first chunk with its own cotangent: its ms
   (1 warm-up, median of 3), its plain version's, the block limits, counts
   equal and two launches bitwise equal.  Then geometry_replay_chunks: the
   geometry replay and the replay kernel side by side on that chunk and on
   a box and a simple chunk of the same size: each one's ms, the geometry
   replay's counts, bound and ratios to its bound and to the replay kernel.
17. geometry_path_scan: ``cli invert --scene simple --width 200 --height
   200 --total-spp 4 --max-depth 100 --fields p0,radius,albedo,camera
   --steps 2 --no-replay-backward`` (cut from the full width: its eager
   launches): the 'scan' route, no replay or geometry replay launch, the
   scan VJP once a chunk, losses finite, seconds and steps/s.
18. replay_route: the step's albedo and emission gradients on the card
   for scenes the replay kernel does not take (random_spheres, 100
   spheres, float32: forward kernel and plain replay; box in float64 and
   with tent jitter: plain wavefront loop and plain replay), no replay
   kernel launch, against the CPU's: within 1e-9 (float64) or tier 1
   (float32); the seconds of the CPU and card parts.  Then the five
   phases' seconds in all (``geometry_phases``).

19-25. The single-process host runtime and the suite, each through the CLI
   with the kernels' launch counts set to 0 just before it and read just
   after, each record with its seconds (``host_runtime_phases``: their
   sum).  tiled_path: ``cli render`` of disco 1024x768, 32 total spp, in 6
   tiles with ``--inject-fault 1:2,4``: 6 forward-kernel launches, the
   image (from the checkpoint's sums) bitwise equal to ``render_image``'s
   and the PNG byte for byte; past ``--max-retries`` the run raises
   ``TileRenderError`` after 3 tiles, and the rerun from the checkpoint
   launches 3 and gives the same bits; the host-clock time of 1, 6 and 24
   tiles beside the one-pass render, and of a checkpoint save.
   progressive_path: ``--checkpoint --flush-every 2 --preview`` at 16
   total spp (2 launches), then the same command at 32 resumes (2 more):
   sums and image bitwise equal to an uninterrupted progressive render,
   max |delta| against the one pass (<= 1e-5), the preview written and by
   which writer (native or NumPy), the cost of a flush.  invert_resume:
   the production inverse, 4 steps straight against 2 steps, a save, a new
   step function, a load and 2 more (10 forward and 10 replay launches):
   params and Adam's state bitwise, the counter on the host and the
   moments on the card; a changed lr refused; the same through ``cli
   invert --checkpoint`` (the checkpoints bitwise equal).  scene_file:
   ``save_scene`` of box_mirror, then ``--scene-file``: 1 launch, bitwise
   equal to the registered scene.  debug_nans: a guarded render (1
   launch) and a guarded inverse step (10 forward, 5 replay) pass; a scene
   file with a NaN light raises ``FloatingPointError``.  bench_suite: ``cli
   bench --suite --suite-scale 1``: a line per row (seconds, Mrays/s,
   occupancy, lane efficiency, path-length percentiles, forward launches;
   every row on the kernel), the inverse row (5 and 5 launches a step;
   the steps/s of each of 3 windows of 3 steps) and the markdown table it
   wrote (``--suite-out``).  Then, outside that window, each row's first
   and last launch again at its shapes (table, camera, cell_start 0,
   sample_start, items): the first and the last 131,072 items of each
   bitwise equal to the plain version, with the plain version's time on
   those items and the kernel's time on a launch of the first 131,072.
   bench_headline: ``scripts/torch_bench.py``'s JSON line.

26-30. The mesh and multi-process paths on the one card, each record with
   nvidia-smi's name and power limit, the kernels' launch counts set to 0
   just before each path and read just after (``parallel_phases``: their
   seconds).  sharded_render: disco 1024x768, 32 total spp, max_depth 100
   on ``make_mesh(4, 1, [cuda:0] * 4)`` and ``make_mesh(2, 2, ...)``: 4
   forward launches a render, the 4x1 image bitwise equal to
   ``render_image``'s, the 2x2 within 1e-6 * max(1, |ref|) with its max
   |delta|, each timed with CUDA events (1 warm-up, median of 3) beside the
   one pass; the shards' overlap: a CUDA event on each shard's stream as
   its ``render_cells_range`` starts and after its last kernel, every
   shard's start before the previous shard's end (no host wait on the
   previous shard between them), and, as a control, the 4x1 mesh's four
   shards run one after another on one stream read as not overlapped.
   multiprocess_render: ``cli render --num-processes 2
   --coordinator 127.0.0.1:<free port> --process-id {0,1}``, both ranks on
   cuda:0, the same disco, three runs (replicated; ``--shard-dir``;
   ``--shard-dir --inject-shard-loss 1 --shard-timeout 3``): each PNG byte
   for byte the one-process ``cli render`` PNG, the return codes (rank 1
   exits 3 in the loss run), the shard directory (``LOST_HOSTS`` and
   ``shard_00000.npz`` alone after the loss), each run's wall seconds and
   each rank's forward launches.  sharded_train_path: the production
   inverse step through ``make_sharded_accum_train_step`` on a 2x2 mesh of
   cuda:0: 20 forward and 20 replay launches a step; the first step's loss
   within 1e-5 relative and each gradient within 1e-5 of its largest
   magnitude against the one-device step on the card; steps/s of 3
   CUDA-event-timed steps after a warm-up beside the one-device step's;
   ``cli invert --mesh 2x2 --steps 2`` (5 + 40 forward, 40 replay
   launches).  entry_twin: ``entry()`` once (1 forward launch) and
   ``dryrun_multichip(4)`` on ``[cuda:0] * 4`` (12 forward launches, no
   replay).  bench_scaling: ``cli bench --scaling`` on disco, one row.

31. parity_artifact: ``scripts/torch_smoke.py``'s ``run()`` in process, its
   artifact to a temporary file: for every registered scene at 96x64, 4
   samples a cell, max_depth 8 and 100, the batch route, the plain
   wavefront, K4 and K2 held to each other and K2 to the JAX package's
   committed XLA wavefront renders (``tests/data/smoke/``: the pin gate at
   8, tier 2 at 100) and the float64 batch route to the JAX one (1e-9);
   the sharded render on (1,1) and (2,1) meshes of the card bitwise; K3
   and K7 against the JAX gradients on box and simple, and K7's plain
   version in float64 against the JAX float64 ones (1e-9).  A line a scene
   and a section, then its seconds; any failed row raises.

Then a ``{"kernels": [...]}`` line (six kernels, each with its launches on
its path, its time, its plain version's, its bound, the least time the card
could take for the same work at its published peaks, which side binds, the
probe-model time of the render kernels, and a library call's time where one
PyTorch call computes the same; the whole-render kernel also its launches on
the geometry path, on each host-runtime path and on each mesh or multi-process path
(``launches_parallel``); the whole-render, replay and geometry replay
kernels also with their registers, the threads resident an SM and the
launch's occupancy, the geometry replay's bound from the forward's
operations, the sweeps' and its record's bytes (``record_gb``), and its
three chunks of geometry_replay_chunks (``chunks``); the op-chain kernel
per op (``ops``) also a second bound from what its loop issues: each trip's
instructions on the fast path by pipe (from the build's SASS), at the
pipes' rates (``roofline.pipe_bound_ms``), and its time's share of it;
the per-step kernel's bound is the
render's, equal to the whole-render kernel's, with the floor of the
lane-state traffic its design moves beside it as ``state_floor_ms``), the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "cpu_path_tracing_tpu_torch"


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def ptxas_entries(log: str) -> list:
    """Per kernel: registers and the stack/spill line of ``nvcc -Xptxas -v``."""
    from cpu_path_tracing_tpu_torch.utils.roofline import kernel_label

    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = kernel_label(ln.split("'")[1])
            out.append({"kernel": name})
        elif name and "spill" in ln:
            out[-1]["stack_spills"] = ln.strip()
        elif name and "registers" in ln:
            out[-1]["registers"] = int(ln.split("Used ")[1].split(" registers")[0])
    return out


def max_ulp(a, b) -> int:
    """Largest distance in float32 steps between two tensors of finite
    values of one sign."""
    import torch

    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def load_script(name: str):
    """Import ``scripts/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def replay_deviation(got, ref, n_spheres: int, blocks=None):
    """Per block of the replay partials (``blocks``: the replay kernel's by
    default, or the geometry replay's): worst |got - ref| and its limit,
    1e-4 * max|ref block| + 1e-7.  Returns (record, ok, worst |got - ref|)."""
    from cpu_path_tracing_tpu_torch.ops.replay import partial_blocks

    rec, ok, worst = {}, True, 0.0
    for name, sl in (blocks or partial_blocks)(n_spheres).items():
        g, r = got[sl].double().cpu(), ref[sl].double().cpu()
        err, lim = float((g - r).abs().max()), 1e-4 * float(r.abs().max()) + 1e-7
        rec[name] = [err, lim]
        ok = ok and err <= lim
        worst = max(worst, err)
    return rec, ok, worst


def plain_items(table, cam, dyn, i0: int, i1: int, *, cfg, n_cells: int, ior: float):
    """Items [i0, i1) of a forward-kernel launch by its plain version, as
    ``persistent_render_reference`` computes them (an item's radiance
    depends on its index alone): [3, i1 - i0]."""
    from cpu_path_tracing_tpu_torch.ops.integrator import radiance
    from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk

    spheres, camera = mk._unpack(table, cam, ior)
    _, keys, o, d = mk.item_rays(cfg, camera, dyn, n_cells, i0, i1, table.dtype, table.device)
    return radiance(spheres, o, d, keys, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                    epsilon=cfg.epsilon, inf=cfg.inf).T


def cuda_time_ms(fn, runs: int = 3):
    """Median CUDA-event time of fn() after one warm-up; returns (ms, last result)."""
    import torch

    fn()
    times, out = [], None
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], out


def host_runtime(dev, k2: dict, k3: dict) -> None:
    """Phases 19-25: the single-process host runtime and the suite, each
    driven through the CLI (``cli.main``) with the kernels' launch counts
    set to 0 just before and read just after; comparisons run outside those
    windows.  Files go to a temporary directory, removed at the end."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    import cpu_path_tracing_tpu_torch as tp
    from cpu_path_tracing_tpu_torch import cli, grad
    from cpu_path_tracing_tpu_torch.models.io import load_scene, save_scene
    from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
    from cpu_path_tracing_tpu_torch.ops.kernels import replay as rk
    from cpu_path_tracing_tpu_torch.orchestrator import TileRenderError, TileState, render_tiled
    from cpu_path_tracing_tpu_torch.render import finalize_image, sample_chunk_for
    from cpu_path_tracing_tpu_torch.utils import checkpoint as ckpt
    from cpu_path_tracing_tpu_torch.utils import native
    from cpu_path_tracing_tpu_torch.utils.image import write_png

    def zero():
        mk.persistent_render.launches = rk.replay_persistent.launches = 0

    def counts():
        return mk.persistent_render.launches, rk.replay_persistent.launches

    def run_cli(argv):
        """cli.main(argv) with its stdout and stderr captured; (rc, out, err)."""
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        return rc, out.getvalue(), err.getvalue()

    def shown(argv):
        """The command line as a user types it, without the temporary directory."""
        return "python -m cpu_path_tracing_tpu_torch.cli " + " ".join(
            a.replace(work + os.sep, "") for a in argv)

    def wall(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    k2["launches_host_runtime"], k3["launches_host_runtime"] = {}, {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    work = tmp.name
    disco = ["--scene", "box_mirror", "--width", "1024", "--height", "768", "--total-spp", "32",
             "--max-depth", "100"]
    cfg = tp.RenderConfig(width=1024, height=768, spp=8, max_depth=100)
    scene = tp.get_scene("box_mirror", cfg.width, cfg.height).to(dev)
    ref = tp.render_image(scene, cfg)  # the one-pass image every phase is held to
    ref_png = os.path.join(work, "ref.png")
    write_png(ref_png, ref.cpu())
    ref_bytes = open(ref_png, "rb").read()

    def image_of(sums, spp):
        return finalize_image(torch.from_numpy(sums).to(dev) / spp, cfg)

    # ---- 19. tiled_path ----
    t_phase = time.perf_counter()
    tile = cfg.num_cells // 6
    tiles, tiles2 = os.path.join(work, "tiles.npz"), os.path.join(work, "tiles2.npz")
    out_png = os.path.join(work, "tiled.png")
    argv = ["render", *disco, "-o", out_png, "--tile-cells", str(tile), "--checkpoint", tiles]
    zero()
    t0 = time.perf_counter()
    rc, _, _ = run_cli([*argv, "--inject-fault", "1:2,4"])
    cli_s = time.perf_counter() - t0
    k2_tiled = counts()[0]
    state = TileState.load(tiles)
    bitwise = bool(torch.equal(image_of(state.sums, cfg.spp), ref))
    png_equal = open(out_png, "rb").read() == ref_bytes
    # Past --max-retries: the run fails, and a rerun renders only what is missing.
    zero()
    try:
        run_cli(["render", *disco, "-o", out_png, "--tile-cells", str(tile), "--checkpoint",
                 tiles2, "--inject-fault", "3:3", "--max-retries", "2"])
        raised = None
    except TileRenderError as err:
        raised = repr(err.__cause__)
    k2_failed = counts()[0]
    done_after_failure = TileState.load(tiles2).done.tolist()
    zero()
    rc2, _, _ = run_cli(["render", *disco, "-o", out_png, "--tile-cells", str(tile),
                         "--checkpoint", tiles2])
    k2_resume = counts()[0]
    resumed_bitwise = bool(torch.equal(image_of(TileState.load(tiles2).sums, cfg.spp), ref))
    resumed_png = open(out_png, "rb").read() == ref_bytes
    # The tiled render against the one-pass render (host clock, ended by a sync).
    untiled_s = min(wall(lambda: tp.render_image(scene, cfg).cpu())[0] for _ in range(3))
    tiled_s = {}
    for n_tiles in (1, 6, 24):
        tiled_s[n_tiles] = min(wall(lambda: render_tiled(scene, cfg, tile_cells=cfg.num_cells
                                                         // n_tiles).cpu())[0]
                               for _ in range(3))
    save_s = min(wall(lambda: state.save(tiles))[0] for _ in range(3))
    rec = {"phase": "tiled_path", "command": shown([*argv, "--inject-fault", "1:2,4"]),
           "tiles": len(state.done), "tile_cells": tile, "k2_launches": k2_tiled,
           "cli_seconds": cli_s, "bitwise": bitwise, "png_equal": png_equal,
           "past_max_retries": raised, "done_after_failure": done_after_failure,
           "k2_launches_failed_run": k2_failed, "k2_launches_resume": k2_resume,
           "resumed_bitwise": resumed_bitwise, "resumed_png_equal": resumed_png,
           "untiled_seconds": untiled_s,
           "tiled_seconds_by_tiles": tiled_s, "tile_checkpoint_save_seconds": save_s,
           "checkpoint_mb": os.path.getsize(tiles) / 1e6}
    rec["ok"] = (rc == 0 and rc2 == 0 and k2_tiled == 6 and bitwise and png_equal
                 and raised is not None and "InjectedFault" in raised
                 and done_after_failure == [True] * 3 + [False] * 3 and k2_failed == 3
                 and k2_resume == 3 and resumed_bitwise and resumed_png)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the tiled render: launches, bits or the resume")
    k2["launches_host_runtime"]["tiled_path"] = k2_tiled

    # ---- 20. progressive_path ----
    t_phase = time.perf_counter()
    prog, prog2 = os.path.join(work, "progress.npz"), os.path.join(work, "progress2.npz")
    preview = os.path.join(work, "preview.png")
    argv = ["render", *disco[:-4], "--max-depth", "100", "-o", out_png, "--checkpoint", prog,
            "--flush-every", "2", "--preview", preview]
    zero()
    rc, _, _ = run_cli([*argv, "--total-spp", "16"])  # stopped after two flushes
    k2_first = counts()[0]
    stopped_at = ckpt.ProgressiveState.load(prog).spp_done
    zero()
    rc2, _, _ = run_cli([*argv, "--total-spp", "32"])  # the same command to 32: resumes
    k2_resumed = counts()[0]
    resumed = ckpt.ProgressiveState.load(prog)
    straight = ckpt.render_progressive(scene, cfg, prog2, flush_every=2)
    straight_state = ckpt.ProgressiveState.load(prog2)
    img = image_of(resumed.sums, cfg.spp)
    delta = float((img - ref).abs().max())
    flush_s = min(wall(lambda: resumed.save(prog))[0] for _ in range(3))
    rec = {"phase": "progressive_path",
           "command": shown(argv) + " --total-spp 16, then --total-spp 32",
           "k2_launches_first": k2_first, "stopped_at_spp": stopped_at,
           "k2_launches_resumed": k2_resumed, "spp_done": resumed.spp_done,
           "sums_bitwise_vs_uninterrupted": bool(np.array_equal(resumed.sums,
                                                                straight_state.sums)),
           "image_bitwise_vs_uninterrupted": bool(torch.equal(img, straight)),
           "max_abs_delta_vs_single_pass": delta,
           "png_written": os.path.exists(preview), "writer": "native" if native.available()
           else "numpy", "checkpoint_flush_seconds": flush_s,
           "checkpoint_mb": os.path.getsize(prog) / 1e6}
    rec["ok"] = (rc == 0 and rc2 == 0 and k2_first == 2 and stopped_at == 4 and k2_resumed == 2
                 and resumed.spp_done == 8 and rec["sums_bitwise_vs_uninterrupted"]
                 and rec["image_bitwise_vs_uninterrupted"] and delta <= 1e-5
                 and rec["png_written"])
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the progressive render: launches, bits or the preview")
    k2["launches_host_runtime"]["progressive_path"] = k2_first + k2_resumed

    # ---- 21. invert_resume ----
    t_phase = time.perf_counter()
    icfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    box = tp.get_scene("box", icfg.width, icfg.height).to(dev)
    chunk = 1 << 17
    target = grad.render_target(box, icfg, chunk)
    fields = ("albedo", "emission")
    p0 = {k: v + 0.02 for k, v in grad.split_params(box, fields).items()}
    fp = ckpt.invert_fingerprint(box, icfg, fields, 1e-2, cell_chunk=chunk, sample_chunk=1)
    straight_fn = grad.make_accum_train_step(box, icfg, 1e-2, cell_chunk=chunk)
    p = p0
    for _ in range(4):
        p, _ = straight_fn(p, target)
    first = grad.make_accum_train_step(box, icfg, 1e-2, cell_chunk=chunk)
    q = p0
    for _ in range(2):
        q, _ = first(q, target)
    inv = os.path.join(work, "inv.npz")
    sd = first.state_dict()
    ckpt.InvertState(sd["params"], sd["optimizer"], 2, fp).save(inv)
    st = ckpt.load_or_init_invert(inv, fp, p0)
    again = grad.make_accum_train_step(box, icfg, 1e-2, cell_chunk=chunk)
    again.load_state_dict({"params": st.params, "optimizer": st.opt_state})
    q = st.params
    zero()
    for _ in range(2):
        q, _ = again(q, target)
    torch.cuda.synchronize()
    k2_api, k3_api = counts()
    a, b = straight_fn.state_dict()["optimizer"]["state"], again.state_dict()["optimizer"]["state"]
    params_bitwise = all(torch.equal(p[k], q[k]) for k in p)
    adam_bitwise = all(torch.equal(a[i][key], b[i][key]) for i in a
                       for key in ("step", "exp_avg", "exp_avg_sq"))
    devices = sorted({f"{key}:{b[i][key].device.type}:{b[i][key].dtype}" for i in b
                      for key in ("step", "exp_avg", "exp_avg_sq")})
    try:
        ckpt.load_or_init_invert(inv, ckpt.invert_fingerprint(box, icfg, fields, 5e-3,
                                                              cell_chunk=chunk, sample_chunk=1),
                                 p0)
        lr_refused = False
    except ValueError:
        lr_refused = True
    # The same through the CLI: 2 steps, then the same command to 4 resumes,
    # against 4 uninterrupted steps.
    iargv = ["invert", "--scene", "box", "--width", "400", "--height", "400", "--total-spp",
             "64", "--max-depth", "100"]
    c_path, d_path = os.path.join(work, "c.npz"), os.path.join(work, "d.npz")
    t0 = time.perf_counter()
    run_cli([*iargv, "--steps", "4", "--checkpoint", d_path])
    run_cli([*iargv, "--steps", "2", "--checkpoint", c_path])
    zero()
    rc, out, err = run_cli([*iargv, "--steps", "4", "--checkpoint", c_path])
    k2_cli, k3_cli = counts()
    cli_s = time.perf_counter() - t0
    zc, zd = np.load(c_path), np.load(d_path)
    cli_bitwise = sorted(zc.files) == sorted(zd.files) and all(
        np.array_equal(zc[k], zd[k]) for k in zc.files)
    try:
        run_cli([*iargv, "--steps", "5", "--checkpoint", c_path, "--lr", "5e-3"])
        cli_refused = False
    except ValueError:
        cli_refused = True
    rec = {"phase": "invert_resume", "config": "box 400x400, 64 total spp, max_depth 100, "
           "albedo+emission, 131,072-cell chunks", "params_bitwise": params_bitwise,
           "adam_bitwise": adam_bitwise, "adam_state": devices,
           "k2_launches_resumed_2_steps": k2_api, "k3_launches_resumed_2_steps": k3_api,
           "lr_refused": lr_refused, "cli_resumed": "at step 2" in err,
           "cli_steps_printed": [json.loads(ln)["step"] for ln in out.splitlines()
                                 if ln.startswith("{")],
           "cli_checkpoints_bitwise": cli_bitwise, "cli_lr_refused": cli_refused,
           "k2_launches_cli_resume": k2_cli, "k3_launches_cli_resume": k3_cli,
           "cli_seconds": cli_s}
    rec["ok"] = (params_bitwise and adam_bitwise and k2_api == 10 and k3_api == 10 and lr_refused
                 and rc == 0 and rec["cli_resumed"] and rec["cli_steps_printed"] == [2, 3]
                 and cli_bitwise and cli_refused and k2_cli == 5 + 10 and k3_cli == 10
                 and "step:cpu:torch.float32" in devices
                 and "exp_avg:cuda:torch.float32" in devices)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the inverse resume: bits, launches or the fingerprint")
    k2["launches_host_runtime"]["invert_resume"] = k2_api + k2_cli
    k3["launches_host_runtime"]["invert_resume"] = k3_api + k3_cli

    # ---- 22. scene_file ----
    t_phase = time.perf_counter()
    spath = os.path.join(work, "disco.json")
    save_scene(spath, tp.get_scene("box_mirror", cfg.width, cfg.height))
    zero()
    rc, _, _ = run_cli(["render", "--scene-file", spath, *disco[2:], "-o", out_png])
    k2_sf = counts()[0]
    loaded = load_scene(spath, cfg.width, cfg.height).to(dev)
    rec = {"phase": "scene_file",
           "command": shown(["render", "--scene-file", spath, *disco[2:], "-o", out_png]),
           "k2_launches": k2_sf,
           "png_equal": open(out_png, "rb").read() == ref_bytes,
           "bitwise": bool(torch.equal(tp.render_image(loaded, cfg), ref))}
    rec["ok"] = rc == 0 and k2_sf == 1 and rec["png_equal"] and rec["bitwise"]
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the scene file does not render the registered scene")
    k2["launches_host_runtime"]["scene_file"] = k2_sf

    # ---- 23. debug_nans ----
    t_phase = time.perf_counter()
    zero()
    rc, _, _ = run_cli(["render", *disco, "-o", out_png, "--debug-nans"])
    k2_guarded = counts()[0]
    png_equal = open(out_png, "rb").read() == ref_bytes
    zero()
    rc2, _, _ = run_cli([*iargv, "--steps", "1", "--debug-nans"])
    k2_inv, k3_inv = counts()
    nan_scene = tp.get_scene("box_mirror", cfg.width, cfg.height)
    light = int(torch.nonzero(nan_scene.emission.sum(1) > 0)[0])
    nan_scene.emission[light] = float("nan")
    npath = os.path.join(work, "nan.json")
    save_scene(npath, nan_scene)
    zero()
    try:
        run_cli(["render", "--scene-file", npath, *disco[2:], "-o", out_png, "--debug-nans"])
        caught = None
    except FloatingPointError as err:
        caught = str(err)
    k2_nan = counts()[0]
    rec = {"phase": "debug_nans", "k2_launches_guarded_render": k2_guarded,
           "png_equal": png_equal, "k2_launches_guarded_step": k2_inv,
           "k3_launches_guarded_step": k3_inv, "nan_light_sphere": light,
           "floating_point_error": caught, "k2_launches_nan_render": k2_nan}
    rec["ok"] = (rc == 0 and png_equal and k2_guarded == 1 and rc2 == 0 and k2_inv == 5 + 5
                 and k3_inv == 5 and caught is not None and "render_cells_range" in caught
                 and k2_nan == 1)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the NaN guard: a route left the card, or a NaN went through")
    k2["launches_host_runtime"]["debug_nans"] = k2_guarded + k2_inv + k2_nan
    k3["launches_host_runtime"]["debug_nans"] = k3_inv

    # ---- 24. bench_suite ----
    t_phase = time.perf_counter()
    suite_md = os.path.join(work, "suite.md")
    zero()
    rc, out, _ = run_cli(["bench", "--suite", "--suite-scale", "1", "--suite-out", suite_md])
    k2_suite, k3_suite = counts()
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    rows, inv_row = recs[:-1], recs[-1]
    for r in rows:
        emit({"phase": "bench_suite", "scene": r["scene"],
              "resolution": f"{r['width']}x{r['height']}", "total_spp": r["total_spp"],
              "route": r["route"], "k2_launches": r["k2_launches"], "seconds": r["seconds"],
              "mrays_per_s": r["mrays_per_s"], "segments": r["segments"],
              "avg_depth": r["avg_depth"], "occupancy": r.get("occupancy"),
              "lane_efficiency": r["lane_efficiency"],
              "depth_percentiles": r.get("depth_percentiles"), "device": r["device"]})
    emit({"phase": "bench_suite", "inverse": inv_row})
    # Each row's first and last launch again, outside the counted window, at
    # the row's shapes: the head and the tail span of each against the plain
    # version, bitwise.
    span = 1 << 17
    rows_ok = len(rows) == len(cli.BENCH_MATRIX)
    for (name, w, h, tspp), r in zip(cli.BENCH_MATRIX, rows):
        rcfg = tp.RenderConfig(width=w, height=h, spp=max(1, tspp // 4), max_depth=100)
        rscene = tp.get_scene(name, w, h).to(dev)
        table, cam = mk.pack_scene(rscene), mk.pack_camera(rscene)
        n_cells = rcfg.num_cells
        chunk = sample_chunk_for(rcfg.spp, n_cells)
        n_items = chunk * n_cells
        kw = dict(cfg=rcfg, n_cells=n_cells, ior=rscene.ior)
        checked, bitwise, err, plain_ms = [], True, 0.0, 0.0
        for s0 in sorted({0, rcfg.spp - chunk}):  # the first and the last launch
            got = mk.persistent_render(table, cam, (0, s0), n_items=n_items, **kw)[0]
            for i0 in (0, n_items - span):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                ref = plain_items(table, cam, (0, s0), i0, i0 + span, **kw)
                end.record()
                torch.cuda.synchronize()
                plain_ms += start.elapsed_time(end)
                part = got[:, i0:i0 + span]
                bitwise = bitwise and bool(torch.equal(part, ref))
                err = max(err, float((part - ref).abs().max()))
                checked.append([s0, i0])
        first_ms, _ = cuda_time_ms(lambda: mk.persistent_render(table, cam, (0, 0),
                                                                n_items=span, **kw))
        first_plain_ms, _ = cuda_time_ms(lambda: plain_items(table, cam, (0, 0), 0, span, **kw),
                                         runs=1)
        row = {"phase": "bench_suite_vs_plain", "scene": name, "spheres": rscene.num_spheres,
               "launch_items": n_items, "samples_a_launch": chunk,
               "launches_expected": rcfg.spp // chunk, "k2_launches": r["k2_launches"],
               "checked_sample_start_item": checked, "items_checked": span * len(checked),
               "bitwise": bitwise, "max_abs_err": err, "plain_ms": plain_ms,
               "kernel_ms_first_span": first_ms, "plain_ms_first_span": first_plain_ms,
               "row_seconds": r["seconds"]}
        row["ok"] = (bitwise and r["route"] == "pallas" and r["scene"] == name
                     and r["k2_launches"] == rcfg.spp // chunk and r["mrays_per_s"] > 0)
        emit(row)
        rows_ok = rows_ok and row["ok"]
        del got, ref, part
    expected = [(n, s) for n, _, _, s in cli.BENCH_MATRIX]
    rec = {"phase": "bench_suite_total", "rows": len(rows), "k2_launches": k2_suite,
           "k3_launches": k3_suite, "rows_bitwise_vs_plain": rows_ok,
           "table": open(suite_md).read()}
    rec["ok"] = (rc == 0 and [(r["scene"], r["total_spp"]) for r in rows] == expected
                 and rows_ok and inv_row["k2_launches_per_step"] == 5
                 and len(inv_row["steps_per_s_windows"]) == 3
                 and inv_row["k3_launches_per_step"] == 5 and inv_row["steps_per_s"] > 0
                 and k2_suite > 0 and k3_suite > 0)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the benchmark suite: a row left the kernels, or failed")
    k2["launches_host_runtime"]["bench_suite"] = k2_suite
    k3["launches_host_runtime"]["bench_suite"] = k3_suite
    tmp.cleanup()

    # ---- 25. bench_headline ----
    t_phase = time.perf_counter()
    tb = load_script("torch_bench")
    zero()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tb.main([])
    k2_head = counts()[0]
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    rec = {"phase": "bench_headline", "command": "python3 scripts/torch_bench.py", "line": line,
           "k2_launches": k2_head}
    rec["ok"] = rc == 0 and line["value"] > 0 and k2_head == 6
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the headline benchmark")
    k2["launches_host_runtime"]["bench_headline"] = k2_head


# A rank of the multi-process render: ``cli.main`` with its forward-kernel
# launches printed as a JSON line when it returns or leaves by os._exit (a
# lost rank, or a survivor of one).
RANK_WRAPPER = """
import json, os, sys
from cpu_path_tracing_tpu_torch import cli
from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
_exit = os._exit
def report(code):
    print(json.dumps({"rc": code, "k2_launches": mk.persistent_render.launches}), flush=True)
def leave(code):
    report(code)
    _exit(code)
os._exit = leave
rc = cli.main(sys.argv[1:])
report(rc)
sys.exit(rc)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_paths(dev, k2: dict, k3: dict, k7: dict, smi: str) -> None:
    """Phases 26-30: the mesh and multi-process paths (``parallel/``,
    ``grad.make_sharded_*``, ``entry.py``) on the one card, each with the
    kernels' launch counts set to 0 just before it is driven and read just
    after.  One card shows the plumbing, not scaling: a mesh's entries are
    the same card, and two ranks share it."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    import cpu_path_tracing_tpu_torch as tp
    from cpu_path_tracing_tpu_torch import cli, grad
    from cpu_path_tracing_tpu_torch.entry import dryrun_multichip, entry
    from cpu_path_tracing_tpu_torch.ops.kernels import geometry_replay as gk
    from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
    from cpu_path_tracing_tpu_torch.ops.kernels import replay as rk
    from cpu_path_tracing_tpu_torch.parallel import render as pr
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh
    from cpu_path_tracing_tpu_torch.parallel.render import render_image_sharded

    def zero():
        mk.persistent_render.launches = rk.replay_persistent.launches = 0
        gk.geometry_replay.launches = 0

    def shard_overlap(render):
        """``render()`` with a CUDA event on the stream of each shard's
        ``render_cells_range`` call as it starts and after its last kernel,
        the shards in the order of the calls (mesh order).  Overlapped:
        every shard started before the previous one's last kernel ended, so
        no host wait on the previous shard came between."""
        marks = []
        real = pr.render_cells_range

        def traced(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            out = real(*args, **kw)
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            marks.append((a, b))
            return out

        pr.render_cells_range = traced
        try:
            render()
        finally:
            pr.render_cells_range = real
        torch.cuda.synchronize()
        t0 = marks[0][0]
        leads = [a.elapsed_time(b_prev) for (a, _), (_, b_prev) in zip(marks[1:], marks)]
        return {"shards": len(marks),
                "start_end_ms": [[t0.elapsed_time(a), t0.elapsed_time(b)] for a, b in marks],
                "start_before_previous_end_ms": leads,
                "overlapped": len(marks) > 1 and all(x > 0 for x in leads)}

    def counts():
        torch.cuda.synchronize()
        return mk.persistent_render.launches, rk.replay_persistent.launches

    def run_cli(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        return rc, out.getvalue(), err.getvalue()

    k2["launches_parallel"], k3["launches_parallel"] = {}, {}
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    disco = ["--scene", "box_mirror", "--width", "1024", "--height", "768", "--total-spp", "32",
             "--max-depth", "100"]
    cfg = tp.RenderConfig(width=1024, height=768, spp=8, max_depth=100)
    scene = tp.get_scene("box_mirror", cfg.width, cfg.height).to(dev)
    cards = [dev] * 4

    # ---- 26. sharded_render ----
    t_phase = time.perf_counter()
    ref = tp.render_image(scene, cfg)
    one_ms, _ = cuda_time_ms(lambda: tp.render_image(scene, cfg))
    rec = {"phase": "sharded_render", "nvidia_smi": smi,
           "config": "box_mirror 1024x768, 32 total spp, max_depth 100; meshes of cuda:0 x 4",
           "one_pass_ms": one_ms}
    ok = True
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(*shape, cards)
        zero()
        img = render_image_sharded(scene, cfg, mesh)
        launches = counts()[0]
        ms, _ = cuda_time_ms(lambda: render_image_sharded(scene, cfg, mesh))
        lim = 1e-6 * torch.clamp(ref.abs(), min=1.0)
        delta = (img - ref).abs()
        tag = f"{shape[0]}x{shape[1]}"
        rec[tag] = {"k2_launches": launches, "ms": ms, "bitwise": bool(torch.equal(img, ref)),
                    "max_abs_delta": float(delta.max()),
                    "within_1e-6": bool((delta <= lim).all()),
                    "shard_overlap": shard_overlap(lambda: render_image_sharded(scene, cfg,
                                                                                mesh))}
        ok = (ok and launches == 4 and rec[tag]["within_1e-6"]
              and rec[tag]["shard_overlap"]["shards"] == 4
              and rec[tag]["shard_overlap"]["overlapped"])
        k2["launches_parallel"][f"sharded_render_{tag}"] = launches

    # The control: the same 4 shards of the 4x1 mesh one after another on
    # one stream, as the mesh ran before its SPMD runner, must read as not
    # overlapped.
    def serial():
        per = pr.tile_span(cfg, 4)
        for t in range(4):
            ids = torch.arange(t * per, (t + 1) * per, dtype=torch.int64, device=dev)
            pr.render_cells_range(scene, cfg, ids, 0, cfg.spp)

    rec["serial_control"] = shard_overlap(serial)
    rec["ok"] = (ok and rec["4x1"]["bitwise"] and rec["serial_control"]["shards"] == 4
                 and not rec["serial_control"]["overlapped"])
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the sharded render: launches, bits, the 1e-6 limit or the shards' overlap")

    # ---- 27. multiprocess_render ----
    t_phase = time.perf_counter()
    one_png = os.path.join(work, "one.png")
    rc, _, _ = run_cli(["render", *disco, "-o", one_png])
    check(rc == 0, "the one-process cli render failed")
    one_bytes = open(one_png, "rb").read()
    env = dict(os.environ, PYTHONPATH=HERE)
    runs = {}
    for name, extra, want_rc in (
            ("replicated", [], {0: 0, 1: 0}),
            ("shard_dir", ["--shard-dir", os.path.join(work, "shards")], {0: 0, 1: 0}),
            ("shard_loss", ["--shard-dir", os.path.join(work, "lost"), "--inject-shard-loss", "1",
                            "--shard-timeout", "3"], {0: 0, 1: 3})):
        png = os.path.join(work, f"{name}.png")
        port = free_port()
        argv = ["render", *disco, "--num-processes", "2", "--coordinator", f"127.0.0.1:{port}",
                "-o", png, *extra]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", RANK_WRAPPER, *argv, "--process-id",
                                   str(r)], cwd=HERE, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in (0, 1)]
        outs = {}
        try:
            for r, proc in enumerate(procs):
                out, err = proc.communicate(timeout=300)
                lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
                outs[r] = {"rc": proc.returncode,
                           "k2_launches": lines[-1]["k2_launches"] if lines else None,
                           "stderr_tail": err.strip().splitlines()[-2:]}
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        run = {"command": "python -m cpu_path_tracing_tpu_torch.cli " + " ".join(
                   a.replace(work + os.sep, "") for a in argv) + " --process-id {0,1}",
               "wall_seconds": time.perf_counter() - t0, "ranks": outs,
               "png_equal": os.path.exists(png) and open(png, "rb").read() == one_bytes}
        run["ok"] = run["png_equal"] and {r: o["rc"] for r, o in outs.items()} == want_rc
        if "--shard-dir" in extra:
            run["shard_dir"] = sorted(os.listdir(extra[1]))
            want = (["LOST_HOSTS", "shard_00000.npz"] if name == "shard_loss"
                    else ["shard_00000.npz", "shard_00001.npz"])
            run["ok"] = run["ok"] and run["shard_dir"] == want
        runs[name] = run
    want_k2 = {"replicated": {0: 1, 1: 1}, "shard_dir": {0: 1, 1: 1},
               "shard_loss": {0: 2, 1: 1}}  # rank 0 re-renders the lost rank's cells
    rec = {"phase": "multiprocess_render", "nvidia_smi": smi,
           "config": "box_mirror 1024x768, 32 total spp, max_depth 100; 2 ranks on cuda:0, gloo",
           "runs": runs}
    rec["ok"] = all(r["ok"] for r in runs.values()) and all(
        {k: o["k2_launches"] for k, o in runs[n]["ranks"].items()} == want_k2[n] for n in runs)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the multi-process render: return codes, PNG bytes, shards or launches")
    k2["launches_parallel"]["multiprocess_render"] = sum(
        o["k2_launches"] for r in runs.values() for o in r["ranks"].values())

    # ---- 28. sharded_train_path ----
    t_phase = time.perf_counter()
    icfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    box = tp.get_scene("box", icfg.width, icfg.height).to(dev)
    chunk = 1 << 17
    target = grad.render_target(box, icfg, chunk)
    p0 = {k: v + 0.02 for k, v in grad.split_params(box, ("albedo", "emission")).items()}
    mesh = make_mesh(2, 2, cards)
    l1, g1 = grad.make_accum_loss_grad(box, icfg, cell_chunk=chunk, sample_chunk=1)(p0, target)
    zero()
    l2, g2 = grad.make_sharded_accum_loss_grad(mesh, box, icfg, cell_chunk=chunk,
                                               sample_chunk=1)(p0, target)
    k2_step, k3_step = counts()
    loss_rel = abs(float(l2) - float(l1)) / abs(float(l1))
    grad_dev = {k: float((g2[k] - g1[k]).abs().max()) / float(g1[k].abs().max()) for k in g1}

    def steps_per_s(step):
        p, _ = step(p0, target)  # warm-up
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            p, loss = step(p, target)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return [1e3 / t for t in times], float(loss)

    single_sps, single_loss = steps_per_s(grad.make_accum_train_step(box, icfg, 1e-2,
                                                                     cell_chunk=chunk))
    zero()
    sharded_sps, sharded_loss = steps_per_s(grad.make_sharded_accum_train_step(
        mesh, box, icfg, 1e-2, cell_chunk=chunk))
    k2_timed, k3_timed = counts()
    iargv = ["invert", "--scene", "box", "--width", "400", "--height", "400", "--total-spp", "64",
             "--max-depth", "100", "--mesh", "2x2", "--steps", "2"]
    zero()
    t0 = time.perf_counter()
    rc, out, _ = run_cli(iargv)
    cli_s = time.perf_counter() - t0
    k2_cli, k3_cli = counts()
    cli_lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    rec = {"phase": "sharded_train_path", "nvidia_smi": smi,
           "config": "box 400x400, 64 total spp, max_depth 100, albedo+emission, 131,072-cell "
                     "chunks, mesh 2x2 of cuda:0",
           "k2_launches_per_step": k2_step, "k3_launches_per_step": k3_step,
           "loss_single": float(l1), "loss_sharded": float(l2), "loss_rel_dev": loss_rel,
           "grad_dev_over_max": grad_dev,
           "steps_per_s_single": single_sps, "steps_per_s_sharded": sharded_sps,
           "loss_after_4_steps_single": single_loss, "loss_after_4_steps_sharded": sharded_loss,
           "k2_launches_4_steps": k2_timed, "k3_launches_4_steps": k3_timed,
           "cli": {"command": "python -m cpu_path_tracing_tpu_torch.cli " + " ".join(iargv),
                   "rc": rc, "seconds": cli_s, "losses": [r["loss"] for r in cli_lines],
                   "k2_launches": k2_cli, "k3_launches": k3_cli}}
    rec["ok"] = (k2_step == 20 and k3_step == 20 and loss_rel <= 1e-5
                 and all(v <= 1e-5 for v in grad_dev.values())
                 and k2_timed == 80 and k3_timed == 80 and rc == 0 and len(cli_lines) == 2
                 and all(np.isfinite(r["loss"]) for r in cli_lines)
                 and k2_cli == 5 + 40 and k3_cli == 40)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "the sharded inverse step: launches, loss or gradients against one device")
    k2["launches_parallel"]["sharded_train_path"] = k2_step + k2_timed + k2_cli
    k3["launches_parallel"]["sharded_train_path"] = k3_step + k3_timed + k3_cli

    # ---- 29. entry_twin ----
    t_phase = time.perf_counter()
    zero()
    fn, args = entry()
    out = fn(*args)
    k2_entry = counts()[0]
    zero()
    dry = dryrun_multichip(4, cards)
    k2_dry, k3_dry = counts()
    k7_dry = gk.geometry_replay.launches
    rec = {"phase": "entry_twin", "nvidia_smi": smi, "entry_shape": list(out.shape),
           "entry_device": str(out.device), "entry_mean": float(out.mean()),
           "k2_launches_entry": k2_entry, "dryrun_multichip_4": dry,
           "k2_launches_dryrun": k2_dry, "k3_launches_dryrun": k3_dry,
           "k7_launches_dryrun": k7_dry}
    # The dryrun's forward kernel: the accumulation step's 2 chunks x 4
    # shards and the kernel route's 4 shards; the accumulation step's
    # backward (p0, radius, albedo) is the 'geometry' route: the geometry
    # replay kernel and the replay kernel once a shard and chunk.
    rec["ok"] = (tuple(out.shape) == (256 * 192 * 4, 3) and out.device.type == "cuda"
                 and bool(torch.isfinite(out).all()) and k2_entry == 1
                 and dry["mesh"] == {"tiles": 2, "samples": 2} and k2_dry == 12 and k3_dry == 8
                 and k7_dry == 8)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "entry() or dryrun_multichip(4) on the card")
    k2["launches_parallel"]["entry_twin"] = k2_entry + k2_dry
    k3["launches_parallel"]["entry_twin"] = k3_dry
    k7["launches_parallel"] = {"entry_twin": k7_dry}

    # ---- 30. bench_scaling ----
    t_phase = time.perf_counter()
    table = os.path.join(work, "scaling.md")
    zero()
    rc, out, _ = run_cli(["bench", "--scaling", *disco, "--suite-out", table])
    k2_scaling = counts()[0]
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    rec = {"phase": "bench_scaling", "nvidia_smi": smi, "rows": rows, "k2_launches": k2_scaling,
           "table": open(table).read()}
    rec["ok"] = (rc == 0 and [r["devices"] for r in rows] == [1] and k2_scaling == 4
                 and rows[0]["seconds"] > 0 and rec["table"].startswith("# Strong scaling"))
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    check(rec["ok"], "bench --scaling")
    k2["launches_parallel"]["bench_scaling"] = k2_scaling
    shutil.rmtree(work, ignore_errors=True)


def parity_artifact(dev) -> None:
    """Phase 31: ``scripts/torch_smoke.py``'s ``run()`` in process, every
    registered scene held to the port's own routes and to the JAX package's
    committed renders, the replay and geometry kernels to its gradients; a
    JSON line a scene and a section, the artifact written to a temporary
    file (not the committed ``TORCH_SMOKE.md``).  Raises if a row or a
    section failed."""
    import tempfile

    smoke = load_script("torch_smoke")
    records = []

    def record(r):
        records.append(r)
        emit({"phase": "parity_artifact", **r})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parity_") as work:
        out = os.path.join(work, "TORCH_SMOKE.md")
        rc = smoke.run(out_path=out, device=str(dev), on_record=record)
        table = open(out).read()
    failed = [r.get("section", r.get("scene")) for r in records if not r["ok"]]
    emit({"phase": "parity_artifact_seconds", "seconds": time.perf_counter() - t0, "rc": rc,
          "rows": len(records), "failed": failed,
          "artifact_lines": len(table.splitlines())})
    check(rc == 0 and not failed,
          f"the parity artifact: rc {rc}, {failed} failed (scripts/torch_smoke.py)")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"{PKG}/ is not beside chip_smoke.py: run this from a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the chip smoke test runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    import cpu_path_tracing_tpu_torch as tp
    from cpu_path_tracing_tpu_torch import _build, cli, grad, render
    from cpu_path_tracing_tpu_torch.ops import wavefront
    from cpu_path_tracing_tpu_torch.ops import rng as rng_ops
    from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
    from cpu_path_tracing_tpu_torch.ops.kernels import probe as pk
    from cpu_path_tracing_tpu_torch.ops.kernels import replay as rk
    from cpu_path_tracing_tpu_torch.utils import parity, profiling, roofline

    # The kernels' per-item radiance is [3, items]: the channel axis is 0.
    tier1 = functools.partial(parity.tier1, axis=0)
    tier2 = functools.partial(parity.tier2, axis=0)
    tpp = load_script("torch_perf_probe")
    tcm = load_script("torch_chip_measure")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log = lib_path.with_suffix(".log").read_text() if lib_path.with_suffix(".log").exists() else ""
    ptxas = ptxas_entries(log)
    build_s = time.perf_counter() - t0
    # What each probe loop holds: the arithmetic instruction of a simple
    # body must be there once per application (not folded, not hoisted out
    # of the loop).
    loops = roofline.sass_loops(_build.sass())
    probe_loops, loops_ok = {}, True
    signature = {"mul_add": ("FMUL", "FADD"), "fma": ("FFMA",), "add": ("FADD",),
                 "sqrt": ("MUFU",), "rsqrt": ("MUFU",), "u32_round": ("SHF",)}
    for op, spec in pk.OPS.items():
        loop = loops[f"probe_op_chain_kernel<{spec.code},{tpp.n_arrays(op)}>"]
        apps = tpp.n_arrays(op) * spec.unroll
        probe_loops[op] = {"instructions": loop["instructions"], "applications": apps,
                           "signature": {k: loop["opcodes"].get(k, 0)
                                         for k in signature.get(op, ())},
                           "fast_path": loop["fast_path"]}
        loops_ok = loops_ok and all(loop["opcodes"].get(k, 0) >= apps
                                    for k in signature.get(op, ()))
    loops_ok = loops_ok and loops[f"probe_op_chain_kernel<{pk.OPS['mul_add'].code},8>"][
        "opcodes"].get("FFMA", 0) == 0
    emit({"phase": "build", "seconds": round(build_s, 3), "library": lib_path.name,
          "ptxas": [e for e in ptxas if not e["kernel"].startswith("probe_op_chain_kernel")
                    or e["kernel"] in {f"probe_op_chain_kernel<{spec.code},{tpp.n_arrays(op)}>"
                                       for op, spec in pk.OPS.items()}],
          "probe_loops": probe_loops, "probe_loops_ok": loops_ok})
    by_name = {e["kernel"]: e for e in ptxas}
    check(set(by_name) >= {"persistent_render_kernel<u32>", "persistent_render_kernel<i64>",
                           "megakernel_step_kernel", "replay_kernel<u32,8>",
                           "replay_kernel<u32,16>", "replay_kernel<u32,40>",
                           "geometry_replay_kernel<u32,8>", "geometry_replay_kernel<u32,16>",
                           "geometry_replay_kernel<u32,40>",
                           "probe_stream_kernel", "probe_op_chain_kernel<0,8>"},
          "the build log lacks a kernel")
    spilled = [k for k, e in by_name.items()
               if k.startswith(("persistent_render_kernel", "replay_kernel",
                                "geometry_replay_kernel"))
               and not k.endswith(",40>") and ", 0 bytes spill stores" not in e["stack_spills"]]
    check(not spilled, f"ptxas spilled registers in {spilled}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(loops_ok, "a probe loop lacks its arithmetic instruction (folded or hoisted), or the "
                    "mul-add chain was contracted")

    # ---- 3. kernel vs plain version, every scene ----
    W, H, SPP = 64, 48, 2
    for name in tp.scene_names():
        scene = tp.get_scene(name, W, H)
        table, cam = mk.pack_scene(scene).to(dev), mk.pack_camera(scene).to(dev)
        rec = {"phase": "kernel_vs_plain", "scene": name, "spheres": scene.num_spheres}
        for depth in (8, 100):
            cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=depth)
            kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=SPP * cfg.num_cells, ior=scene.ior)
            got = mk.persistent_render(table, cam, (0, 0), **kw)[0].cpu().numpy()
            ref = mk.persistent_render_reference(table, cam, (0, 0), **kw)[0].cpu().numpy()
            rec[f"d{depth}_exact_frac"] = float(np.mean(got == ref))
            rec[f"d{depth}_bitwise"] = bool(np.array_equal(got, ref))
            if depth == 8:
                t1 = tier1(got, ref)
                rec["d8_p999"], rec["d8_frac_above_1e-3"] = t1["p999"], t1["frac_above_1e-3"]
                ok = t1["ok"]
            else:
                kw["cfg"] = cfg.replace(seed=1234)
                alt = mk.persistent_render_reference(table, cam, (0, 0), **kw)[0].cpu().numpy()
                t2 = tier2(got, ref, alt)
                rec["d100_mean_dev"], rec["d100_seed_yardstick"] = (t2["mean_dev"],
                                                                    t2["seed_yardstick"])
                rec["d100_channel_ratios"] = t2["channel_ratios"]
                ok = t2["ok"]
            rec[f"d{depth}_ok"] = ok and rec[f"d{depth}_bitwise"]
        emit(rec)
        check(rec["d8_ok"] and rec["d100_ok"], f"kernel vs plain version on {name}")

    # Regeneration: more items than threads, nonzero cell_start/sample_start.
    cfg = tp.RenderConfig(width=1024, height=768, spp=8, max_depth=100)
    scene = tp.get_scene("box_mirror", cfg.width, cfg.height).to(dev)
    table, cam = mk.pack_scene(scene), mk.pack_camera(scene)
    total = cfg.num_cells
    for how, cell_start, n_cells, sample_start, samples in (
            ("render_cells_range", 1_000_003, 150_001, 5, 2),
            ("past_last_cell", total - 50_000, 100_000, 6, 2),
            ("items_no_multiple_of_32", 777, 12_345, 3, 3),
            ("fewer_items_than_a_warp", 2_000_001, 7, 9, 3),
            ("cells_past_2^31", 2**31 + 12_345, 5_000, 3, 2)):
        if cell_start >= 2**31:  # a 32768 x 32768 image: the kernel's 64-bit items
            cfg = tp.RenderConfig(width=32768, height=32768, spp=8, max_depth=100)
            scene = tp.get_scene("box_mirror", cfg.width, cfg.height).to(dev)
            table, cam = mk.pack_scene(scene), mk.pack_camera(scene)
        n_items = samples * n_cells
        kw = dict(cfg=cfg, n_cells=n_cells, n_items=n_items, ior=scene.ior)
        bits = mk.index_bits(mk.launch_params(cfg, (cell_start, sample_start), n_spheres=8,
                                              n_cells=n_cells, n_items=n_items, ior=scene.ior))
        got, st = mk.persistent_render(table, cam, (cell_start, sample_start), **kw)
        ref, ref_st = mk.persistent_render_reference(table, cam, (cell_start, sample_start), **kw)
        rec = {"phase": "kernel_regen", "case": how, "cell_start": cell_start,
               "n_cells": n_cells, "sample_start": sample_start, "n_items": n_items,
               "index_bits": bits, "lanes": st["lanes"], "items_per_lane": n_items / st["lanes"],
               "segments": [int(st["segments"]), ref_st["segments"]],
               "bitwise": bool(torch.equal(got, ref)),
               **tier1(got.cpu().numpy(), ref.cpu().numpy())}
        ok = (rec["ok"] and rec["bitwise"] and int(st["segments"]) == ref_st["segments"]
              and (st["lanes"] < n_items or n_items < 100_000)
              and bits == (64 if cell_start >= 2**31 else 32))
        if how == "render_cells_range":
            ids = torch.arange(cell_start, cell_start + n_cells, device=dev)
            sums = render.render_cells_range(scene, cfg, ids, sample_start, 2)
            ref_sums = (ref[:, :n_cells] + ref[:, n_cells:]).T
            sums_t1 = tier1(sums.T.cpu().numpy(), ref_sums.T.cpu().numpy())
            rec["sums_p999"], rec["sums_ok"] = sums_t1["p999"], sums_t1["ok"]
            ok = ok and sums_t1["ok"]
        rec["ok"] = ok
        emit(rec)
        check(ok, f"regenerating launch ({how}) against the plain version")

    # ---- 4. the committed JAX pins ----
    pin_cfg = tp.RenderConfig(width=W, height=H, spp=2, max_depth=16)
    for name in ("box", "box_mirror", "simple"):
        img = tp.render_image(tp.get_scene(name, W, H).to(dev), pin_cfg).cpu().numpy()
        ref = np.load(os.path.join(HERE, "tests", "data", f"pin_{name}_64x48.npz"))["img"]
        rec = {"phase": "pins", "scene": name, **parity.pin_gate(img, ref)}
        emit(rec)
        check(rec["ok"], f"pinned render {name}")

    # ---- 5. the main path at full size ----
    cfg = tp.RenderConfig(width=1024, height=768, spp=8, max_depth=100)
    scene = tp.get_scene("box_mirror", cfg.width, cfg.height).to(dev)
    mk.persistent_render.launches = rk.replay_persistent.launches = 0
    img = tp.render_image(scene, cfg)
    torch.cuda.synchronize()
    launches = mk.persistent_render.launches
    check(launches >= 1, "render_image did not launch the kernel")
    check(tuple(img.shape) == (768, 1024, 3) and bool(torch.isfinite(img).all())
          and float(img.max()) > 0, "main-path image is not finite and non-zero")

    ids = torch.arange(cfg.num_cells, device=dev)
    range_ms, (_, stats) = cuda_time_ms(
        lambda: render.render_cells_range(scene, cfg, ids, 0, cfg.spp, with_stats=True))
    segments, iters, lanes = int(stats["segments"]), int(stats["iters"]), int(stats["lanes"])

    table, cam = mk.pack_scene(scene), mk.pack_camera(scene)
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=cfg.spp * cfg.num_cells, ior=scene.ior)
    kernel_ms, (got, _) = cuda_time_ms(lambda: mk.persistent_render(table, cam, (0, 0), **kw))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref, ref_stats = mk.persistent_render_reference(table, cam, (0, 0), **kw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    t1 = tier1(got, ref)
    main_bitwise = bool(np.array_equal(got, ref))
    max_abs_err = float(np.abs(got - ref).max())
    seconds = range_ms / 1e3
    emit({"phase": "main_path", "config": "box_mirror 1024x768, 32 total spp, max_depth 100",
          "launches": launches, "image_mean": float(img.mean()), "segments": segments,
          "seconds": seconds, "mrays_per_s": segments / seconds / 1e6,
          "occupancy": segments / (iters * lanes), "iters": iters, "lanes": lanes,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "plain_segments": ref_stats["segments"], "max_abs_err": max_abs_err,
          "bitwise": main_bitwise, **t1})
    check(t1["ok"] and main_bitwise, "kernel vs plain version at the main path's size (bitwise)")
    check(segments == ref_stats["segments"], "kernel and plain version count different segments")

    # The bound: 12 bytes written per item and the scene read once, against
    # the operations these paths need (utils/roofline.py) at one issue each.
    k2_ops = roofline.render_ops(scene.num_spheres, segments, kw["n_items"])
    k2_bound, k2_by = roofline.bound_ms(12 * kw["n_items"] + 4 * (table.numel() + cam.numel()),
                                        k2_ops.issues())
    k2 = {"name": "persistent_render", "route": "cuda", "source": f"{PKG}/csrc/megakernel.cu",
          "replaces": "cpu_path_tracing_tpu/ops/pallas/megakernel.py:726",
          "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
          "registers": by_name["persistent_render_kernel<u32>"]["registers"],
          "resident_threads_per_sm": lanes // sms, "occupancy": segments / (iters * lanes)}

    # ---- 6. the replay kernel vs its plain version ----
    worst = 0.0
    for name in tp.scene_names():
        scene = tp.get_scene(name, W, H)
        table, cam = mk.pack_scene(scene).to(dev), mk.pack_camera(scene).to(dev)
        rec = {"phase": "replay_vs_plain", "scene": name, "spheres": scene.num_spheres}
        cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
        ct = torch.from_numpy(np.random.default_rng(11).normal(0, 1, (cfg.num_cells, 3))
                              .astype(np.float32)).to(dev)
        kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=SPP * cfg.num_cells, ior=scene.ior)
        if scene.num_spheres > rk.MAX_REPLAY_SPHERES:
            try:
                rk.replay_persistent(table, cam, (0, 0), ct, **kw)
                rec["rejected"] = False
            except ValueError as e:  # the documented rejection is the expected outcome
                rec["rejected"] = f"1..{rk.MAX_REPLAY_SPHERES} spheres" in str(e)
            emit(rec)
            check(rec["rejected"], f"replay kernel did not reject {name} ({scene.num_spheres} "
                                   "spheres)")
            continue
        ok = True
        for depth in (8, 100):
            kw["cfg"] = cfg.replace(max_depth=depth)
            got, st = rk.replay_persistent(table, cam, (0, 0), ct, **kw)
            ref, ref_st = rk.replay_persistent_reference(table, cam, (0, 0), ct, **kw)
            dev_rec, blocks_ok, err = replay_deviation(got, ref, scene.num_spheres)
            worst = max(worst, err)
            rec[f"d{depth}_segments"] = [int(st["segments"]), ref_st["segments"]]
            rec[f"d{depth}_blocks"] = dev_rec
            ok = ok and blocks_ok and int(st["segments"]) == ref_st["segments"]
        rec["ok"] = ok
        emit(rec)
        check(ok, f"replay kernel vs plain version on {name}")

    cfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    scene = tp.get_scene("box", cfg.width, cfg.height).to(dev)
    table, cam = mk.pack_scene(scene), mk.pack_camera(scene)
    total = cfg.num_cells
    for how, cell_start, n_cells, sample_start in (("mid_image", 100_003, 150_001, 5),
                                                   ("past_last_cell", total - 50_000, 100_000, 6)):
        ct = torch.from_numpy(np.random.default_rng(12).normal(0, 1, (n_cells, 3))
                              .astype(np.float32)).to(dev)
        kw = dict(cfg=cfg, n_cells=n_cells, n_items=2 * n_cells, ior=scene.ior)
        got, st = rk.replay_persistent(table, cam, (cell_start, sample_start), ct, **kw)
        again, _ = rk.replay_persistent(table, cam, (cell_start, sample_start), ct, **kw)
        ref, ref_st = rk.replay_persistent_reference(table, cam, (cell_start, sample_start), ct,
                                                     **kw)
        dev_rec, blocks_ok, err = replay_deviation(got, ref, scene.num_spheres)
        worst = max(worst, err)
        rec = {"phase": "replay_vs_plain", "case": how, "cell_start": cell_start,
               "n_cells": n_cells, "sample_start": sample_start, "n_items": kw["n_items"],
               "lanes": st["lanes"], "items_per_lane": kw["n_items"] / st["lanes"],
               "segments": [int(st["segments"]), ref_st["segments"]], "blocks": dev_rec,
               "bitwise_repeat": bool(torch.equal(got, again))}
        rec["ok"] = (blocks_ok and rec["bitwise_repeat"] and st["lanes"] < kw["n_items"]
                     and int(st["segments"]) == ref_st["segments"])
        emit(rec)
        check(rec["ok"], f"regenerating replay launch ({how}) against the plain version")

    # ---- 7. the production inverse step ----
    chunk = 1 << 17
    target = grad.render_target(scene, cfg, chunk)
    true = grad.split_params(scene, ("albedo", "emission"))
    params = {k: v + 0.02 for k, v in true.items()}
    step = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=chunk)
    mk.persistent_render.launches = rk.replay_persistent.launches = 0
    losses, step_ms, per_step = [], [], []
    t0 = time.perf_counter()
    params, loss = step(params, target)  # warm-up
    losses.append(float(loss))
    warm_s = time.perf_counter() - t0
    for _ in range(5):
        before = rk.replay_persistent.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, loss = step(params, target)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        per_step.append(rk.replay_persistent.launches - before)
    k3_launches, k2_train_launches = rk.replay_persistent.launches, mk.persistent_render.launches
    check(k3_launches >= 1 and k2_train_launches >= 1, "the train step did not launch both kernels")

    # The first full chunk at the current params, with the step's cotangent:
    # d/d(sum) of sum((sum/S - target)^2) = 2 (sum/S - target) / S.
    sc = grad.merge_params(scene, params)
    ids = torch.arange(chunk, device=dev)
    ct = (2.0 * (render.render_cells_range(sc, cfg, ids, 0, cfg.spp) / cfg.spp - target[:chunk])
          / cfg.spp).contiguous()
    table, cam = mk.pack_scene(sc), mk.pack_camera(sc)
    kw = dict(cfg=cfg, n_cells=chunk, n_items=cfg.spp * chunk, ior=sc.ior)
    fwd_ms, (fwd, fwd_st) = cuda_time_ms(lambda: mk.persistent_render(table, cam, (0, 0), **kw))
    fwd_ref, fwd_ref_st = mk.persistent_render_reference(table, cam, (0, 0), **kw)
    fwd, fwd_ref = fwd.cpu().numpy(), fwd_ref.cpu().numpy()
    fwd_t1 = tier1(fwd, fwd_ref)
    fwd_bitwise = bool(np.array_equal(fwd, fwd_ref))
    k2["max_abs_err"] = max(k2["max_abs_err"], float(np.abs(fwd - fwd_ref).max()))
    bwd_ms, (got, st) = cuda_time_ms(lambda: rk.replay_persistent(table, cam, (0, 0), ct, **kw))
    again, _ = rk.replay_persistent(table, cam, (0, 0), ct, **kw)
    chunk_repeat = bool(torch.equal(got, again))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref, ref_st = rk.replay_persistent_reference(table, cam, (0, 0), ct, **kw)
    end.record()
    torch.cuda.synchronize()
    bwd_plain_ms = start.elapsed_time(end)
    dev_rec, blocks_ok, err = replay_deviation(got, ref, sc.num_spheres)
    worst = max(worst, err)
    mean_err = {k: float((params[k] - true[k]).abs().mean()) for k in params}
    regs = [by_name["replay_kernel<u32,8>"]]
    rec = {"phase": "train_path",
           "config": "box 400x400, 64 total spp, max_depth 100, albedo+emission, Adam lr 1e-2, "
                     "cell_chunk 131072",
           "steps_per_s": 5 / (sum(step_ms) / 1e3), "step_ms": step_ms, "warmup_s": warm_s,
           "losses": losses, "replay_launches_per_step": per_step,
           "replay_launches": k3_launches, "forward_launches": k2_train_launches,
           "forward_kernel_ms_per_chunk": fwd_ms,
           "forward_chunk_vs_plain": {"segments": [int(fwd_st["segments"]),
                                                   fwd_ref_st["segments"]],
                                      "max_abs_err": float(np.abs(fwd - fwd_ref).max()),
                                      "bitwise": fwd_bitwise, **fwd_t1},
           "forward_chunk_occupancy": int(fwd_st["segments"]) / (
               int(fwd_st["iters"]) * fwd_st["lanes"]),
           "replay_kernel_ms_per_chunk": bwd_ms,
           "replay_plain_ms_per_chunk": bwd_plain_ms, "chunk_items": kw["n_items"],
           "chunk_segments": [int(st["segments"]), ref_st["segments"]],
           "chunk_prefix_terms": ref_st["prefix_terms"],
           "chunk_lanes": st["lanes"], "chunk_occupancy": int(st["segments"]) / (
               int(st["iters"]) * st["lanes"]),
           "chunk_blocks": dev_rec, "chunk_bitwise_repeat": chunk_repeat,
           "replay_ptxas": regs, "mean_abs_err_after": mean_err}
    rec["ok"] = (per_step == [5] * 5 and all(np.isfinite(losses)) and losses[-1] < losses[0]
                 and blocks_ok and chunk_repeat and int(st["segments"]) == ref_st["segments"]
                 and fwd_t1["ok"] and fwd_bitwise
                 and int(fwd_st["segments"]) == fwd_ref_st["segments"])
    emit(rec)
    check(rec["ok"], "the production inverse step")

    # One chunk: the cotangent and the scene read once, the partials written
    # once, against the forward's operations plus the accumulation's for the
    # non-zero prefix terms the plain version counted on this chunk.
    k3_ops = roofline.render_ops(sc.num_spheres, int(st["segments"]), kw["n_items"],
                                 replay_prefix_terms=ref_st["prefix_terms"])
    k3_bound, k3_by = roofline.bound_ms(
        4 * (ct.numel() + table.numel() + cam.numel() + got.numel()), k3_ops.issues())
    k3 = {"name": "replay_persistent", "route": "cuda", "source": f"{PKG}/csrc/replay.cu",
          "replaces": "cpu_path_tracing_tpu/ops/pallas/replay_kernel.py:248",
          "launches": k3_launches, "max_abs_err": worst, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
          "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None,
          "registers": regs[0]["registers"], "resident_threads_per_sm": st["lanes"] // sms,
          "occupancy": rec["chunk_occupancy"]}
    # ---- 8. the per-step kernel vs its plain step and the whole-render kernel ----
    step_err = 0.0
    for name in tp.scene_names():
        scene = tp.get_scene(name, W, H).to(dev)
        ids = torch.arange(W * H * 4, device=dev)
        rec = {"phase": "step_vs_plain", "scene": name, "spheres": scene.num_spheres}
        whole_rec = {"phase": "step_vs_persistent", "scene": name}
        for depth in (8, 100):
            cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=depth)
            got, st = wavefront.drive_items(mk.megakernel_step, scene, cfg, ids, 0, SPP)
            ref, ref_st = wavefront.drive_items(mk.megakernel_step_reference, scene, cfg, ids, 0,
                                                SPP)
            whole, whole_st = mk.persistent_render(
                mk.pack_scene(scene), mk.pack_camera(scene), (0, 0), cfg=cfg,
                n_cells=cfg.num_cells, n_items=SPP * cfg.num_cells, ior=scene.ior)
            g, r = got.cpu().numpy(), ref.cpu().numpy()
            step_err = max(step_err, float(np.abs(g - r).max()))
            rec[f"d{depth}_segments"] = [st["segments"], ref_st["segments"]]
            rec[f"d{depth}_iters"] = st["iters"]
            rec[f"d{depth}_exact_frac"] = float(np.mean(g == r))
            if depth == 8:
                t1 = tier1(g, r)
                rec["d8_p999"], rec["d8_frac_above_1e-3"] = t1["p999"], t1["frac_above_1e-3"]
                ok = t1["ok"]
            else:
                alt, _ = wavefront.drive_items(mk.megakernel_step_reference, scene,
                                               cfg.replace(seed=1234), ids, 0, SPP)
                t2 = tier2(g, r, alt.cpu().numpy())
                rec["d100_mean_dev"], rec["d100_seed_yardstick"] = (t2["mean_dev"],
                                                                    t2["seed_yardstick"])
                rec["d100_channel_ratios"] = t2["channel_ratios"]
                ok = t2["ok"]
            rec[f"d{depth}_ok"] = ok
            whole_rec[f"d{depth}_bitwise"] = bool(torch.equal(got, whole))
            whole_rec[f"d{depth}_segments"] = [st["segments"], int(whole_st["segments"])]
            whole_rec[f"d{depth}_ok"] = (whole_rec[f"d{depth}_bitwise"]
                                         and st["segments"] == int(whole_st["segments"]))
        emit(rec)
        emit(whole_rec)
        check(rec["d8_ok"] and rec["d100_ok"], f"per-step kernel vs plain step on {name}")
        check(whole_rec["d8_ok"] and whole_rec["d100_ok"],
              f"per-step kernel vs whole-render kernel on {name}")

    # ---- 9. regenerating per-step loops ----
    cfg = tp.RenderConfig(width=1024, height=768, spp=8, max_depth=100)
    scene = tp.get_scene("box_mirror", cfg.width, cfg.height).to(dev)
    table, cam = mk.pack_scene(scene), mk.pack_camera(scene)
    total = cfg.num_cells
    lanes = 65_536
    for how, cell_start, n_cells, sample_start in (("render_cells_range", 1_000_003, 150_001, 5),
                                                   ("past_last_cell", total - 50_000, 100_000, 6)):
        ids = torch.arange(cell_start, cell_start + n_cells, device=dev)
        got, st = wavefront.drive_items(mk.megakernel_step, scene, cfg, ids, sample_start, 2,
                                        lanes)
        ref, ref_st = wavefront.drive_items(mk.megakernel_step_reference, scene, cfg, ids,
                                            sample_start, 2, lanes)
        whole, whole_st = mk.persistent_render(table, cam, (cell_start, sample_start), cfg=cfg,
                                               n_cells=n_cells, n_items=2 * n_cells,
                                               ior=scene.ior)
        rec = {"phase": "step_regen", "case": how, "cell_start": cell_start, "n_cells": n_cells,
               "sample_start": sample_start, "n_items": 2 * n_cells, "lanes": st["lanes"],
               "items_per_lane": 2 * n_cells / st["lanes"], "iters": st["iters"],
               "segments": [st["segments"], ref_st["segments"], int(whole_st["segments"])],
               "bitwise_vs_persistent": bool(torch.equal(got, whole)),
               **tier1(got.cpu().numpy(), ref.cpu().numpy())}
        step_err = max(step_err, float((got - ref).abs().max()))
        ok = (rec["ok"] and rec["bitwise_vs_persistent"] and st["lanes"] < 2 * n_cells
              and st["segments"] == int(whole_st["segments"]))
        if how == "render_cells_range":
            step_cfg = cfg.replace(integrator="pallas", pallas_persistent=False,
                                   wavefront_lanes=lanes)
            sums = render.render_cells_range(scene, step_cfg, ids, sample_start, 2)
            whole_sums = render.render_cells_range(scene, cfg, ids, sample_start, 2)
            rec["sums_bitwise"] = bool(torch.equal(sums, whole_sums))
            ok = ok and rec["sums_bitwise"]
        rec["ok"] = ok
        emit(rec)
        check(ok, f"regenerating per-step loop ({how})")

    # One launch of S steps against S launches of one, on the first span.
    cell_start, n_cells, sample_start = 1_000_003, 150_001, 5
    kw = dict(cfg=cfg, n_cells=n_cells, n_items=2 * n_cells, lanes=lanes, ior=scene.ior)
    singles = -(-2 * n_cells // lanes) * cfg.max_depth + 1  # the loop's cap
    whole, whole_st = mk.persistent_render(table, cam, (cell_start, sample_start), cfg=cfg,
                                           n_cells=n_cells, n_items=2 * n_cells, ior=scene.ior)
    for steps in (2, 8, 32):
        n_launches = -(-singles // steps)
        sa, sb = mk.init_lane_state(lanes, dev), mk.init_lane_state(lanes, dev)
        oa, ob = (torch.zeros((3, 2 * n_cells), device=dev) for _ in range(2))
        ga, gb = (torch.zeros(n_launches * steps, dtype=torch.int64, device=dev)
                  for _ in range(2))
        state_ok = True
        for n in range(n_launches):
            mk.megakernel_step(sa, table, cam, (cell_start, sample_start), out=oa, seg=ga,
                               seg_slot=n * steps, steps=steps, **kw)
            for j in range(steps):
                mk.megakernel_step(sb, table, cam, (cell_start, sample_start), out=ob, seg=gb,
                                   seg_slot=n * steps + j, **kw)
            state_ok = state_ok and mk.lane_state_equal(sa, sb)
        rec = {"phase": "step_steps", "steps": steps, "launches": n_launches,
               "state_bitwise": state_ok, "out_bitwise": bool(torch.equal(oa, ob)),
               "seg_bitwise": bool(torch.equal(ga, gb)), "segments": int(ga.sum()),
               "iters": int((ga > 0).sum()), "drained": int(sa.i[4].sum()) == 0,
               "out_vs_persistent": bool(torch.equal(oa, whole))}
        rec["ok"] = (state_ok and rec["out_bitwise"] and rec["seg_bitwise"] and rec["drained"]
                     and rec["out_vs_persistent"]
                     and rec["segments"] == int(whole_st["segments"]))
        emit(rec)
        check(rec["ok"], f"one launch of {steps} steps against {steps} launches of one")

    # ---- 10. the per-step slice at full size: cli bench ----
    import contextlib
    import io

    cfg = tp.RenderConfig(width=1024, height=768, spp=8, max_depth=100)
    scene = tp.get_scene("box_mirror", cfg.width, cfg.height).to(dev)
    # No --device: the command line's default is the card.
    argv = ["bench", "--scene", "box_mirror", "--total-spp", "32", "--repeats", "3"]
    mk.persistent_render.launches = mk.megakernel_step.launches = 0
    rk.replay_persistent.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(argv) == 0, "cli bench failed")
    k4_launches = mk.megakernel_step.launches
    check(mk.persistent_render.launches == 0 and rk.replay_persistent.launches == 0,
          "cli bench launched another kernel than the per-step kernel")
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(report["device"].startswith(kind + ", power limit"),
          "cli bench did not run on the card by default")
    S = wavefront.STEPS_PER_LAUNCH
    check(k4_launches * S >= 4 * report["iters"] > 0,
          "cli bench did not launch the per-step kernel for every iteration")

    # The kernel's own time: device rows of torch.profiler over one render
    # (CUDA events around each launch would also count the card's waits for
    # the host).
    from torch.profiler import ProfilerActivity, profile

    ids = torch.arange(cfg.num_cells, device=dev)
    before = mk.megakernel_step.launches
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        got, st = wavefront.drive_items(mk.megakernel_step, scene, cfg, ids, 0, cfg.spp)
        end.record()
        torch.cuda.synchronize()
    loop_ms = start.elapsed_time(end)
    launches_in_render = mk.megakernel_step.launches - before
    by_kernel = profiling.device_time_by_kernel(prof)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    k4_ms = sum(ms for key, (ms, _) in by_kernel.items() if "megakernel_step_kernel" in key)
    k4_count = sum(n for key, (_, n) in by_kernel.items() if "megakernel_step_kernel" in key)
    check(k4_count == launches_in_render and k4_ms > 0,
          "the profiler did not see every per-step launch")
    n_items = cfg.spp * cfg.num_cells
    B = st["lanes"]
    # The lane-state traffic of the design, counted in a launch-by-launch
    # render of the same span (roofline.lane_state_bytes), which must give
    # what the graph-driven loop gave.
    traffic = tcm.step_traffic(scene, cfg, ids, 0, cfg.spp)
    state_bytes = traffic["state_bytes"]
    one_by_one = bool(torch.equal(got, traffic["out"])) and traffic["stats"] == st
    check(traffic["launches"] == launches_in_render,
          "the launch-by-launch render made another number of launches")
    table, cam = mk.pack_scene(scene), mk.pack_camera(scene)
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=n_items, ior=scene.ior)
    whole_ms, (whole, whole_st) = cuda_time_ms(lambda: mk.persistent_render(table, cam, (0, 0),
                                                                            **kw))
    start.record()
    ref, ref_st = wavefront.drive_items(mk.megakernel_step_reference, scene, cfg, ids, 0,
                                        cfg.spp)
    end.record()
    torch.cuda.synchronize()
    plain_step_ms = start.elapsed_time(end)
    bitwise = bool(torch.equal(got, whole))
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    t1 = tier1(g, r)
    step_err = max(step_err, float(np.abs(g - r).max()))
    state_floor_ms = state_bytes / roofline.PEAK_BYTES_PER_S * 1e3
    rec = {"phase": "bench_path", "command": "python -m cpu_path_tracing_tpu_torch.cli "
           + " ".join(argv), "report": report, "k4_launches": k4_launches,
           "steps_per_launch": S, "launches_per_graph": wavefront.STEP_BATCH,
           "iters": st["iters"], "lanes": B, "segments": st["segments"],
           "mrays_per_s": report["mrays_per_s"], "occupancy": report["occupancy"],
           "cli_bench_ms": report["seconds"] * 1e3,
           "k4_kernel_ms": k4_ms, "k4_launches_in_render": launches_in_render,
           "k4_ms_per_launch": k4_ms / launches_in_render, "profiled_loop_ms": loop_ms,
           "profiled_device_ms": device_ms, "profiled_idle_share": 1 - device_ms / loop_ms,
           "bench_idle_share": 1 - k4_ms / (report["seconds"] * 1e3),
           "state_bytes": state_bytes, "state_gb": state_bytes / 1e9,
           "state_bytes_per_launch": state_bytes / launches_in_render,
           "state_floor_ms": state_floor_ms,
           "lanes_carried_in": traffic["carried_in"], "lanes_carried_out": traffic["carried_out"],
           "launch_by_launch_bitwise": one_by_one, "k2_ms": whole_ms,
           "k2_segments": int(whole_st["segments"]), "bitwise_vs_persistent": bitwise,
           "plain_step_ms": plain_step_ms, "plain_segments": ref_st["segments"],
           "max_abs_err_vs_plain": float(np.abs(g - r).max()), **t1}
    rec["ok"] = (bitwise and one_by_one and t1["ok"]
                 and st["segments"] == int(whole_st["segments"])
                 == ref_st["segments"] == report["segments"] and report["lanes"] == 1 << 19)
    emit(rec)
    check(rec["ok"], "the per-step slice at full size")
    # One render: its bound is the work's, whatever implements it, so the
    # whole-render kernel's for the same paths (the scene read and each
    # item's radiance written once, against the operations of these
    # segments).  What the per-step design adds, the lane state crossing
    # device memory once per launch, stands beside it as its own floor.
    k4_ops = roofline.render_ops(scene.num_spheres, st["segments"], n_items)
    k4_bound, k4_by = roofline.bound_ms(12 * n_items + 4 * (table.numel() + cam.numel()),
                                        k4_ops.issues())
    k4 = {"name": "megakernel_step", "route": "cuda", "source": f"{PKG}/csrc/megakernel_step.cu",
          "replaces": "cpu_path_tracing_tpu/ops/pallas/megakernel.py:518",
          "launches": k4_launches, "max_abs_err": step_err, "ms": k4_ms,
          "plain_ms": plain_step_ms, "bound_ms": k4_bound, "bound_by": k4_by,
          "library_ms": None, "state_floor_ms": state_floor_ms,
          "state_gb": state_bytes / 1e9, "steps_per_launch": S,
          "launches_per_render": launches_in_render}

    # ---- 11. float64 and tent jitter on the card: the plain wavefront loop ----
    for name, dtype, jitter in (("box_mirror", torch.float64, "uniform"),
                                ("smallpt", torch.float64, "tent"),
                                ("smallpt", torch.float32, "tent")):
        cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=100, jitter=jitter)
        cpu_scene = tp.get_scene(name, W, H, dtype=dtype)
        scene = tp.get_scene(name, W, H, dtype=dtype).to(dev)  # .to moves a module in place
        counts = (mk.persistent_render.launches, mk.megakernel_step.launches,
                  rk.replay_persistent.launches)
        route = render.resolve_integrator(scene, cfg)
        ids = torch.arange(cfg.num_cells)
        got, st = render.render_cells_range(scene, cfg, ids.to(dev), 0, SPP, with_stats=True)
        torch.cuda.synchronize()
        launched = (mk.persistent_render.launches, mk.megakernel_step.launches,
                    rk.replay_persistent.launches) != counts
        ref = render.render_cells_range(cpu_scene, cfg, ids, 0, SPP)
        g, r = got.cpu().numpy(), ref.numpy()
        rec = {"phase": "wavefront_route", "scene": name, "dtype": str(dtype), "jitter": jitter,
               "route": route, "kernel_launches": launched, "segments": st["segments"]}
        if dtype == torch.float64:
            rec["max_rel_dev"] = float((np.abs(g - r) / np.maximum(np.abs(r), 1e-300)).max())
            close = bool(np.allclose(g, r, rtol=1e-9, atol=1e-12))
        else:
            t1 = tier1(g.T, r.T)
            rec["p999"], close = t1["p999"], t1["ok"]
        rec["ok"] = route == "wavefront" and not launched and close
        emit(rec)
        check(rec["ok"], f"the wavefront route on the card ({name}, {dtype}, {jitter})")

    # ---- 12. the probe kernels vs their plain versions ----
    rng = np.random.default_rng(21)
    ulp_limit = {"fma": 1, "sin": 2, "sqrt": 2, "rsqrt": 2}  # every other op: bitwise
    pk.op_chain.launches = pk.stream_scale.launches = 0
    expected_launches, k5_err, k5_plain_ms, k5_ulp = 0, 0.0, {}, {}
    for op, spec in pk.OPS.items():
        na, worst_ulp, ok = tpp.n_arrays(op), 0, True
        for n, iters in ((64 * 128, 16), (64 * 128, spec.iters), (tpp.FULL_N, 16),
                         (tpp.FULL_N, spec.iters)):
            if spec.words:
                xs = torch.from_numpy(rng.integers(0, 2**32, (na, n), dtype=np.int64)).to(dev)
            else:
                xs = torch.from_numpy(rng.uniform(0.25, 1.5, (na, n)).astype(np.float32)).to(dev)
            got = pk.op_chain(xs, op, iters)
            expected_launches += 1
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ref = pk.op_chain_reference(xs, op, iters)
            end.record()
            torch.cuda.synchronize()
            if (n, iters) == (tpp.FULL_N, spec.iters):
                k5_plain_ms[op] = start.elapsed_time(end)
            if spec.words:
                bits = pk.op_chain(rng_ops.int32_bits(xs), op, iters)
                expected_launches += 1
                ok = ok and torch.equal(got, ref) and torch.equal(
                    rng_ops.words_from_int32(bits), ref)
            else:
                ok = ok and bool(torch.isfinite(got).all())
                worst_ulp = max(worst_ulp, max_ulp(got, ref))
                k5_err = max(k5_err, float((got - ref).abs().max()))
        ok = ok and worst_ulp <= ulp_limit.get(op, 0)
        k5_ulp[op] = worst_ulp
        emit({"phase": "probe_vs_plain", "kernel": "op_chain", "op": op, "n_arrays": na,
              "sizes": [64 * 128, tpp.FULL_N], "iters": [16, spec.iters],
              "bitwise": worst_ulp == 0, "max_ulp": worst_ulp,
              "ulp_limit": ulp_limit.get(op, 0), "plain_ms_full": k5_plain_ms[op], "ok": ok})
        check(ok, f"op_chain({op}) against its plain version")
    stream_ok, k6_err = True, 0.0
    stream_sizes = (tpp.STREAM_N, (1 << 20) + 3, 1000, 3)
    for n in stream_sizes:
        x = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(dev)
        got, ref = pk.stream_scale(x), pk.stream_scale_reference(x)
        stream_ok = stream_ok and torch.equal(got, ref)
        k6_err = max(k6_err, float((got - ref).abs().max()))
    counts_ok = (pk.op_chain.launches == expected_launches
                 and pk.stream_scale.launches == len(stream_sizes))
    emit({"phase": "probe_vs_plain", "kernel": "stream_scale",
          "sizes": list(stream_sizes), "bitwise": stream_ok,
          "op_chain_launches": pk.op_chain.launches,
          "stream_scale_launches": pk.stream_scale.launches,
          "ok": stream_ok and counts_ok})
    check(stream_ok and counts_ok, "stream_scale against its plain version, or a launch count")

    # ---- 13. the probe, end to end ----
    pk.op_chain.launches = pk.stream_scale.launches = 0
    res = tpp.probe()
    k5_launches, k6_launches = pk.op_chain.launches, pk.stream_scale.launches
    check(k5_launches >= len(pk.OPS) and k6_launches >= 1,
          "the probe did not launch both of its kernels")
    # The stream kernel's library call and plain version on the probe's tensor.
    x = torch.arange(tpp.STREAM_N, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    library_ms = tpp.time_ms(lambda: torch.mul(x, 2.0, out=y), 10)
    k6_plain_ms = tpp.time_ms(lambda: pk.stream_scale_reference(x), 10)
    del x, y, got, ref
    rates = {k: res[k] for k in (*tpp.RATE_KEYS.values(), "f32_fma_gflops", "mem_stream_gbps",
                                 "mem_kernel_stream_gbps")}
    shares = res["share_of_peak"]
    rec = {"phase": "probe_path", "command": "python3 scripts/torch_perf_probe.py",
           "probe": res, "op_chain_launches": k5_launches, "stream_scale_launches": k6_launches,
           "k6_gbps": res["mem_kernel_stream_gbps"],
           "k6_share_of_peak": shares["mem_kernel_stream_gbps"],
           "k6_ms": res["ms"]["stream_scale"],
           "torch_mul_ms": library_ms, "k6_vs_torch_mul": res["ms"]["stream_scale"] / library_ms}
    rec["ok"] = (all(np.isfinite(v) and v > 0 for v in rates.values())
                 and set(shares) == set(rates) - {"f32_fma_gflops"}
                 and all(0 < v <= 1.0 for v in shares.values()))
    emit(rec)
    check(rec["ok"], "the probe: a rate is not finite and positive, or a share is above 100%")

    # The op-chain entry sums one launch of every op at the probe's width;
    # an op's bound is its applications times what the counting rule charges
    # one (roofline.CHAIN_OPS: the function's operations, no loop control)
    # over the issue peak, or its bytes if they bind.  Beside it the bound
    # from what the loop issues: each thread's iters / unroll trips of the
    # instructions its SASS runs on the fast path, by pipe, at the pipes'
    # rates (roofline.pipe_bound_ms).
    k5_ops = {}
    for op, spec in pk.OPS.items():
        apps = tpp.n_arrays(op) * tpp.FULL_N * spec.iters
        b_ms, b_by = roofline.bound_ms(4 * (tpp.n_arrays(op) + 1) * tpp.FULL_N,
                                       apps * roofline.CHAIN_OPS[op].issues())
        fast = probe_loops[op]["fast_path"]
        p_ms, p_by = roofline.pipe_bound_ms(fast["pipes"], tpp.FULL_N * spec.iters / spec.unroll)
        k5_ops[op] = {"ms": res["ms"][op], "plain_ms": k5_plain_ms[op], "bound_ms": b_ms,
                      "bound_by": b_by, "max_ulp": k5_ulp[op], "pipe_bound_ms": p_ms,
                      "pipe_bound_by": p_by, "trip_pipes": fast["pipes"],
                      "applications_per_trip": probe_loops[op]["applications"],
                      "share_of_pipe_bound": p_ms / res["ms"][op]}
    k5 = {"name": "op_chain", "route": "cuda", "source": f"{PKG}/csrc/probe.cu",
          "replaces": "scripts/perf_probe.py:46", "launches": k5_launches,
          "max_abs_err": k5_err, "ms": sum(v["ms"] for v in k5_ops.values()),
          "plain_ms": sum(v["plain_ms"] for v in k5_ops.values()),
          "bound_ms": sum(v["bound_ms"] for v in k5_ops.values()),
          "pipe_bound_ms": sum(v["pipe_bound_ms"] for v in k5_ops.values()), "nvidia_smi": smi,
          "bound_by": "operations" if all(v["bound_by"] == "operations"
                                          for v in k5_ops.values()) else "bytes",
          "library_ms": None, "ops": k5_ops}
    k6_bound, k6_by = roofline.bound_ms(2 * 4 * tpp.STREAM_N, tpp.STREAM_N)
    k6 = {"name": "stream_scale", "route": "cuda", "source": f"{PKG}/csrc/probe.cu",
          "replaces": "scripts/perf_probe.py:142", "launches": k6_launches,
          "max_abs_err": k6_err, "ms": res["ms"]["stream_scale"],
          "plain_ms": k6_plain_ms, "bound_ms": k6_bound, "bound_by": k6_by,
          "library_ms": library_ms}
    # ---- 14. the geometry replay kernel vs its plain version ----
    from cpu_path_tracing_tpu_torch.ops import replay as replay_ops
    from cpu_path_tracing_tpu_torch.ops.geometry_replay import geometry_partial_blocks
    from cpu_path_tracing_tpu_torch.ops.integrator import checkpoint as checkpoint_fn
    from cpu_path_tracing_tpu_torch.ops.kernels import geometry_replay as gk
    from cpu_path_tracing_tpu_torch.models.scene import Scene

    def flat(g):
        return dict(zip(*grad.flatten_params(g)))

    def leaf_grads(scene, cfg, fields, **kw):
        target = grad.render_target(scene, cfg) * 0.9
        loss, g = grad.make_accum_loss_grad(scene, cfg, **kw)(grad.split_params(scene, fields),
                                                               target)
        return float(loss), {k: v.double().cpu() for k, v in flat(g).items()}

    def rel_dev(got: dict, ref: dict) -> float:
        """Worst |got - ref| over the largest |ref| of the leaf's field."""
        worst = 0.0
        for field in {n.split(".")[0] for n in ref}:
            names = [n for n in ref if n.split(".")[0] == field]
            scale = max(float(ref[n].abs().max()) for n in names) or 1.0
            worst = max(worst, max(float((got[n] - ref[n]).abs().max()) for n in names) / scale)
        return worst

    def geometry_vs_plain(table, cam, dyn, ct, **kw):
        """K7 twice and its plain version on one launch's inputs."""
        got, st = gk.geometry_replay(table, cam, dyn, ct, **kw)
        again, _ = gk.geometry_replay(table, cam, dyn, ct, **kw)
        ref, ref_st = gk.geometry_replay_reference(table, cam, dyn, ct, **kw)
        dev_rec, blocks_ok, err = replay_deviation(got, ref, table.shape[0],
                                                   geometry_partial_blocks)
        counts = {k: [int(st[k]), ref_st[k]]
                  for k in ("segments", "missed", "sweep_bounces", "tied_bounces")}
        ok = blocks_ok and all(a == b for a, b in counts.values())
        return {"counts": counts, "blocks": dev_rec, "bitwise_repeat": bool(torch.equal(got, again)),
                "lanes": st["lanes"]}, ok and bool(torch.equal(got, again)), err

    t_geo = time.perf_counter()
    geo_fields = ("p0", "radius", "camera")
    k7_worst = 0.0
    for name in tp.scene_names():
        scene = tp.get_scene(name, W, H)
        cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
        rec = {"phase": "geometry_replay_vs_plain", "scene": name, "spheres": scene.num_spheres}
        if scene.num_spheres > rk.MAX_REPLAY_SPHERES:
            card_scene = scene.to(dev)
            rec["route"] = grad.backward_route(card_scene, cfg, geo_fields)
            ok = rec["route"] == "scan"
            if name == "random_spheres":  # the step runs the scan VJP on the card
                gk.geometry_replay.launches = 0
                _, g = leaf_grads(card_scene, cfg, geo_fields, sample_chunk=1)
                rec["k7_launches"] = gk.geometry_replay.launches
                rec["finite"] = all(bool(torch.isfinite(v).all()) for v in g.values())
                ok = ok and rec["k7_launches"] == 0 and rec["finite"]
            rec["ok"] = ok
            emit(rec)
            check(ok, f"{name} ({scene.num_spheres} spheres) did not take the scan VJP")
            continue
        table, cam = mk.pack_scene(scene).to(dev), mk.pack_camera(scene).to(dev)
        ct = torch.from_numpy(np.random.default_rng(13).normal(0, 1, (cfg.num_cells, 3))
                              .astype(np.float32)).to(dev)
        ok = True
        for depth in (8, 100):
            kw = dict(cfg=cfg.replace(max_depth=depth), n_cells=cfg.num_cells,
                      n_items=SPP * cfg.num_cells, ior=scene.ior)
            rec[f"d{depth}"], ok_d, err = geometry_vs_plain(table, cam, (0, 0), ct, **kw)
            k7_worst = max(k7_worst, err)
            ok = ok and ok_d
        rec["ok"] = ok
        emit(rec)
        check(ok, f"geometry replay kernel vs plain version on {name}")

    # Exact ties: simple with every sphere twice, and with its right sphere
    # three times (a copy's roots equal the original's bit for bit).
    simple = tp.get_scene("simple", W, H)
    for how, rows in (("duplicated", [0, 1, 2, 3, 4, 0, 1, 2, 3, 4]),
                      ("tripled", [0, 1, 2, 3, 4, 1, 1])):
        idx = torch.tensor(rows)
        scene = Scene(**{f: getattr(simple, f)[idx] for f in ("p0", "radius", "anchor_dir",
                                                              "emission", "albedo", "material")},
                      background=simple.background, camera=simple.camera, ior=simple.ior)
        table, cam = mk.pack_scene(scene).to(dev), mk.pack_camera(scene).to(dev)
        cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
        ct = torch.from_numpy(np.random.default_rng(15).normal(0, 1, (cfg.num_cells, 3))
                              .astype(np.float32)).to(dev)
        rec = {"phase": "geometry_replay_vs_plain", "scene": f"simple, spheres {how}",
               "spheres": scene.num_spheres, "rows": rows}
        ok = True
        for depth in (8, 100):
            kw = dict(cfg=cfg.replace(max_depth=depth), n_cells=cfg.num_cells,
                      n_items=SPP * cfg.num_cells, ior=scene.ior)
            rec[f"d{depth}"], ok_d, err = geometry_vs_plain(table, cam, (0, 0), ct, **kw)
            k7_worst = max(k7_worst, err)
            ok = ok and ok_d and rec[f"d{depth}"]["counts"]["tied_bounces"][0] > 0
        rec["ok"] = ok
        emit(rec)
        check(ok, f"geometry replay kernel vs plain version with tied roots ({how})")

    cfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    scene = tp.get_scene("simple", cfg.width, cfg.height).to(dev)
    table, cam = mk.pack_scene(scene), mk.pack_camera(scene)
    total = cfg.num_cells
    for how, cell_start, n_cells, sample_start in (("mid_image", 100_003, 150_001, 5),
                                                   ("past_last_cell", total - 50_000, 100_000, 6)):
        ct = torch.from_numpy(np.random.default_rng(14).normal(0, 1, (n_cells, 3))
                              .astype(np.float32)).to(dev)
        kw = dict(cfg=cfg, n_cells=n_cells, n_items=2 * n_cells, ior=scene.ior)
        launch, ok, err = geometry_vs_plain(table, cam, (cell_start, sample_start), ct, **kw)
        k7_worst = max(k7_worst, err)
        rec = {"phase": "geometry_replay_vs_plain", "case": how, "scene": "simple 400x400",
               "cell_start": cell_start, "n_cells": n_cells, "sample_start": sample_start,
               "n_items": kw["n_items"], "items_per_lane": kw["n_items"] / launch["lanes"], **launch}
        rec["ok"] = ok and launch["lanes"] < kw["n_items"]
        emit(rec)
        check(rec["ok"], f"regenerating geometry replay launch ({how}) against the plain version")
    emit({"phase": "geometry_replay_vs_plain_seconds", "seconds": time.perf_counter() - t_geo})

    # ---- 15. the scan VJP on the card ----
    t_scan = time.perf_counter()
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=100)
    for name in ("simple", "box"):
        t0 = time.perf_counter()
        _, ref = leaf_grads(tp.get_scene(name, W, H, dtype=torch.float64), cfg, grad.OPTIMIZABLE,
                            sample_chunk=1)
        t1 = time.perf_counter()
        _, got = leaf_grads(tp.get_scene(name, W, H, dtype=torch.float64).to(dev), cfg,
                            grad.OPTIMIZABLE, sample_chunk=1)
        rec = {"phase": "geometry_grad", "scene": name, "dtype": "float64",
               "config": "64x48, 2 spp, max_depth 100, all six fields, sample_chunk 1",
               "cpu_seconds": t1 - t0, "card_seconds": time.perf_counter() - t1,
               "leaves": len(got), "max_rel_dev": rel_dev(got, ref),
               "max_abs": {n: float(v.abs().max()) for n, v in ref.items()}}
        ok = rec["max_rel_dev"] <= 1e-9 and set(got) == set(ref)
        if name == "box":
            rec["p0_radius_zero"] = all(float(got[k].abs().max()) == 0.0 for k in ("p0", "radius"))
            ok = ok and rec["p0_radius_zero"] and float(got["albedo"].abs().max()) > 0
        rec["ok"] = ok
        emit(rec)
        check(ok, f"float64 geometry gradients on the card against the CPU's ({name})")

    # Float32 on the 'scan' route (replay off): two backward passes of one
    # step bitwise equal, and the backward's recomputed primal against the
    # forward kernel's per-item radiance.
    t0 = time.perf_counter()
    scene = tp.get_scene("simple", W, H).to(dev)
    fields = ("p0", "radius", "albedo", "camera")
    target = grad.render_target(scene, cfg) * 0.9
    loss_grad = grad.make_accum_loss_grad(scene, cfg, sample_chunk=1, replay=False)
    gk.geometry_replay.launches = 0
    g1, g2 = (flat(loss_grad(grad.split_params(scene, fields), target)[1]) for _ in range(2))
    repeat = all(torch.equal(g1[n], g2[n]) for n in g1)
    finite = all(bool(torch.isfinite(v).all()) for v in g1.values())
    bwd_cfg = loss_grad.span.bwd_cfg
    ids = torch.arange(cfg.num_cells, device=dev)
    items, _ = mk.persistent_render(mk.pack_scene(scene), mk.pack_camera(scene), (0, 0), cfg=cfg,
                                    n_cells=cfg.num_cells, n_items=SPP * cfg.num_cells,
                                    ior=scene.ior)
    recomputed = torch.cat([render.render_cells_range(scene, bwd_cfg, ids, s, 1).T
                            for s in range(SPP)], dim=1)
    prim = tier1(recomputed.cpu().numpy(), items.cpu().numpy())
    rec = {"phase": "geometry_grad", "scene": "simple", "dtype": "float32", "fields": fields,
           "route": loss_grad.span.route(fields), "k7_launches": gk.geometry_replay.launches,
           "bwd_cfg": {"loop": bwd_cfg.loop, "remat": bwd_cfg.remat,
                       "compact_schedule": bwd_cfg.compact_schedule},
           "bitwise_repeat": repeat, "finite": finite,
           "recomputed_primal_vs_forward_kernel": prim,
           "card_seconds": time.perf_counter() - t0}
    rec["ok"] = (repeat and finite and prim["ok"] and rec["route"] == "scan"
                 and rec["k7_launches"] == 0)
    emit(rec)
    check(rec["ok"], "float32 geometry gradients: repeat, finiteness, or the recomputed primal")
    emit({"phase": "geometry_grad_seconds", "seconds": time.perf_counter() - t_scan})

    # ---- 16. the geometry path at full width: cli invert on the 'geometry' route ----
    def zero_all():
        mk.persistent_render.launches = rk.replay_persistent.launches = 0
        gk.geometry_replay.launches = 0

    def counted_invert(argv):
        """``cli.main(argv)`` with its stdout captured, counting the scan
        VJP's sample chunks and its checkpointed bounces.  Returns (JSON
        lines, seconds, {"scan_vjp", "checkpoint"})."""
        from cpu_path_tracing_tpu_torch.ops import integrator as integ

        calls = {"scan_vjp": 0, "checkpoint": 0}
        scan_vjp = grad._scan_vjp

        def counted_scan(*a, **k):
            calls["scan_vjp"] += 1
            return scan_vjp(*a, **k)

        def counted_checkpoint(*a, **k):
            calls["checkpoint"] += 1
            return checkpoint_fn(*a, **k)

        grad._scan_vjp, integ.checkpoint = counted_scan, counted_checkpoint
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                check(cli.main(argv) == 0, f"cli {' '.join(argv)} failed")
        finally:
            grad._scan_vjp, integ.checkpoint = scan_vjp, checkpoint_fn
        seconds = time.perf_counter() - t0
        return [json.loads(ln) for ln in buf.getvalue().strip().splitlines()], seconds, calls

    t_path = time.perf_counter()
    geo_argv = ["invert", "--scene", "simple", "--width", "400", "--height", "400", "--total-spp",
                "64", "--max-depth", "100", "--fields", "p0,radius,albedo,camera", "--steps", "3"]
    zero_all()
    torch.cuda.reset_peak_memory_stats()
    lines, invert_s, calls = counted_invert(geo_argv)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k2_geo, k3_geo, k7_geo = (mk.persistent_render.launches, rk.replay_persistent.launches,
                              gk.geometry_replay.launches)
    losses = [r["loss"] for r in lines]
    # The same step, built as cli invert builds it: 3 CUDA-event-timed steps
    # after a warm-up, then one under the profiler.
    cfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    scene = tp.get_scene("simple", cfg.width, cfg.height).to(dev)
    chunk = 1 << 17
    target = grad.render_target(scene, cfg, chunk)
    true = grad.split_params(scene, fields)
    params = cli.perturbed_params(true, 0, 0.05)
    step = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=chunk, sample_chunk=1)
    params, _ = step(params, target)
    step_ms = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, _ = step(params, target)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step(params, target)
        end.record()
        torch.cuda.synchronize()
    prof_ms = start.elapsed_time(end)
    by_kernel = profiling.device_time_by_kernel(prof)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    k7_prof = [v for k, v in by_kernel.items() if "geometry_replay" in k]
    del prof

    # K7 alone on the step's first chunk, with the step's own cotangent.
    sc = grad.merge_params(scene, params)
    ids = torch.arange(chunk, device=dev)
    ct = (2.0 * (render.render_cells_range(sc, cfg, ids, 0, cfg.spp) / cfg.spp - target[:chunk])
          / cfg.spp).contiguous()
    table, cam = mk.pack_scene(sc), mk.pack_camera(sc)
    kw = dict(cfg=cfg, n_cells=chunk, n_items=cfg.spp * chunk, ior=sc.ior)
    k7_ms, (got, st) = cuda_time_ms(lambda: gk.geometry_replay(table, cam, (0, 0), ct, **kw))
    again, _ = gk.geometry_replay(table, cam, (0, 0), ct, **kw)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref, ref_st = gk.geometry_replay_reference(table, cam, (0, 0), ct, **kw)
    end.record()
    torch.cuda.synchronize()
    k7_plain_ms = start.elapsed_time(end)
    dev_rec, blocks_ok, err = replay_deviation(got, ref, sc.num_spheres, geometry_partial_blocks)
    k7_worst = max(k7_worst, err)
    chunk_counts = {k: [int(st[k]), ref_st[k]]
                    for k in ("segments", "missed", "sweep_bounces", "tied_bounces")}
    regs = by_name["geometry_replay_kernel<u32,8>"]
    rec = {"phase": "geometry_path", "command": "python -m cpu_path_tracing_tpu_torch.cli "
           + " ".join(geo_argv), "route": step.span.route(fields),
           "seconds": invert_s, "steps_per_s": lines[-1]["steps_per_s"], "losses": losses,
           "mean_abs_err": lines[-1]["mean_abs_err"], "k2_launches": k2_geo,
           "k3_launches": k3_geo, "k7_launches": k7_geo,
           "launches_per_step": {"k2": (k2_geo - 5) / 3, "k3": k3_geo / 3, "k7": k7_geo / 3},
           "scan_vjp_calls": calls["scan_vjp"], "checkpoint_calls": calls["checkpoint"],
           "peak_memory_gb": peak_gb, "timed_step_ms": step_ms,
           "timed_steps_per_s": 3 / (sum(step_ms) / 1e3), "profiled_step_ms": prof_ms,
           "profiled_device_ms": busy_ms, "busy_share": busy_ms / prof_ms,
           "profiled_launches": sum(n for _, n in by_kernel.values()),
           "profiled_k7": k7_prof, "k7_chunk_ms": k7_ms, "k7_chunk_plain_ms": k7_plain_ms,
           "k7_chunk_items": kw["n_items"], "k7_chunk_counts": chunk_counts,
           "k7_chunk_blocks": dev_rec, "k7_chunk_bitwise_repeat": bool(torch.equal(got, again)),
           "k7_ptxas": regs, "k7_lanes": st["lanes"],
           "seconds_in_all": time.perf_counter() - t_path}
    rec["ok"] = (len(losses) == 3 and all(np.isfinite(losses)) and rec["route"] == "geometry"
                 and k2_geo == 5 + 3 * 5 and k3_geo == 3 * 5 and k7_geo == 3 * 5
                 and calls["scan_vjp"] == 0 and calls["checkpoint"] == 0 and blocks_ok
                 and rec["k7_chunk_bitwise_repeat"]
                 and all(a == b for a, b in chunk_counts.values()))
    emit(rec)
    check(rec["ok"], "the geometry path: route, losses, launches, or K7 on its chunk")
    k2["launches_geometry_path"] = k2_geo
    k3["launches_geometry_path"] = k3_geo

    def k7_chunk(table, cam, ct, part, st, kw):
        """K7's bound on one chunk: K2's forward operations and the sweeps
        this chunk needed, against the record's traffic and the inputs and
        rows.  Returns (record, operations)."""
        counts = {k: int(st[k]) for k in ("segments", "missed", "sweep_bounces", "tied_bounces")}
        ops = roofline.geometry_ops(table.shape[0], counts["segments"], kw["n_items"],
                                    counts["sweep_bounces"], counts["missed"],
                                    counts["tied_bounces"])
        nbytes = (roofline.geometry_record_bytes(counts["segments"], counts["sweep_bounces"],
                                                 kw["n_items"])
                  + 4 * (ct.numel() + table.numel() + cam.numel() + part.numel()))
        bound, by = roofline.bound_ms(nbytes, ops.issues())
        return {**counts, "bound_ms": bound, "bound_by": by, "record_gb": nbytes / 1e9}, ops

    # K7 and K3 on three chunks of 131,072 cells, 16 samples, max_depth 100:
    # the step's first (above), a box and a simple chunk (seeded normal
    # cotangents), each kernel's median of 3 after a warm-up.
    k7_step, k7_ops = k7_chunk(table, cam, ct, got, st, kw)
    k7_step.update(ms=k7_ms, k3_ms=cuda_time_ms(
        lambda: rk.replay_persistent(table, cam, (0, 0), ct, **kw))[0])
    k7_chunks = {"step": k7_step}
    ct_n = torch.from_numpy(np.random.default_rng(16).normal(0, 1, (chunk, 3))
                            .astype(np.float32)).to(dev)
    for name in ("box", "simple"):
        csc = tp.get_scene(name, cfg.width, cfg.height)
        ctab, ccam = mk.pack_scene(csc).to(dev), mk.pack_camera(csc).to(dev)
        ckw = dict(cfg=cfg, n_cells=chunk, n_items=cfg.spp * chunk, ior=csc.ior)
        ms, (cpart, cst) = cuda_time_ms(lambda: gk.geometry_replay(ctab, ccam, (0, 0), ct_n, **ckw))
        k7_chunks[name] = {**k7_chunk(ctab, ccam, ct_n, cpart, cst, ckw)[0], "ms": ms,
                           "k3_ms": cuda_time_ms(lambda: rk.replay_persistent(
                               ctab, ccam, (0, 0), ct_n, **ckw))[0]}
    for c in k7_chunks.values():
        c.update(ratio_to_bound=c["ms"] / c["bound_ms"], ratio_to_k3=c["ms"] / c["k3_ms"])
    emit({"phase": "geometry_replay_chunks", "config": "400x400, 131,072 cells, 16 samples, "
          "max_depth 100", "chunks": k7_chunks, "smi": smi})
    k7 = {"name": "geometry_replay", "route": "cuda", "source": f"{PKG}/csrc/geometry_replay.cu",
          "replaces": "cpu_path_tracing_tpu/grad.py:153 (no pallas_call: XLA autodiff of the "
                      "checkpointed scan)",
          "launches": k7_geo, "max_abs_err": k7_worst, "ms": k7_ms, "plain_ms": k7_plain_ms,
          "bound_ms": k7_step["bound_ms"], "bound_by": k7_step["bound_by"], "library_ms": None,
          "registers": regs["registers"], "resident_threads_per_sm": st["lanes"] // sms,
          "occupancy": int(st["segments"]) / (int(st["iters"]) * st["lanes"]),
          "record_gb": k7_step["record_gb"], "chunks": k7_chunks}

    # ---- 17. the geometry path on the 'scan' route (--no-replay-backward) ----
    scan_argv = ["invert", "--scene", "simple", "--width", "200", "--height", "200", "--total-spp",
                 "4", "--max-depth", "100", "--fields", "p0,radius,albedo,camera", "--steps", "2",
                 "--no-replay-backward"]
    zero_all()
    torch.cuda.reset_peak_memory_stats()
    lines, scan_s, calls = counted_invert(scan_argv)
    torch.cuda.synchronize()
    rec = {"phase": "geometry_path_scan", "command": "python -m cpu_path_tracing_tpu_torch.cli "
           + " ".join(scan_argv),
           "cut": "200x200 at 4 total spp and 2 steps: the scan VJP's eager launches (13-30 us "
                  "of host time each) keep the full width out of the script's time",
           "seconds": scan_s, "steps_per_s": lines[-1]["steps_per_s"],
           "losses": [r["loss"] for r in lines], "k2_launches": mk.persistent_render.launches,
           "k3_launches": rk.replay_persistent.launches,
           "k7_launches": gk.geometry_replay.launches, "scan_vjp_calls": calls["scan_vjp"],
           "checkpoint_calls": calls["checkpoint"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    rec["ok"] = (all(np.isfinite(rec["losses"])) and len(rec["losses"]) == 2
                 and rec["k2_launches"] == 2 + 2 * 2 and rec["k3_launches"] == 0
                 and rec["k7_launches"] == 0 and calls["scan_vjp"] == 2 * 2
                 and calls["checkpoint"] > 0)
    emit(rec)
    check(rec["ok"], "the geometry path on the scan route")

    # ---- 18. the plain replay on the card for scenes the replay kernel does not take ----
    for name, dtype, jitter in (("random_spheres", torch.float32, "uniform"),
                                ("box", torch.float64, "uniform"),
                                ("box", torch.float32, "tent")):
        cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=100, jitter=jitter)
        t0 = time.perf_counter()
        _, ref = leaf_grads(tp.get_scene(name, W, H, dtype=dtype), cfg, ("albedo", "emission"))
        t1 = time.perf_counter()
        scene = tp.get_scene(name, W, H, dtype=dtype).to(dev)
        mk.persistent_render.launches = rk.replay_persistent.launches = 0
        _, got = leaf_grads(scene, cfg, ("albedo", "emission"))
        rec = {"phase": "replay_route", "scene": name, "spheres": scene.num_spheres,
               "dtype": str(dtype), "jitter": jitter, "cpu_seconds": t1 - t0,
               "card_seconds": time.perf_counter() - t1,
               "route": replay_ops.replay_route(scene, cfg),
               "forward_route": render.resolve_integrator(scene, cfg),
               "k2_launches": mk.persistent_render.launches,
               "k3_launches": rk.replay_persistent.launches, "max_rel_dev": rel_dev(got, ref)}
        if dtype == torch.float64:
            close = rec["max_rel_dev"] <= 1e-9
        else:
            t1 = tier1(torch.cat([got[k].reshape(-1) for k in sorted(got)]).numpy()[None],
                       torch.cat([ref[k].reshape(-1) for k in sorted(ref)]).numpy()[None])
            rec["tier1"], close = t1, t1["ok"]
        kernel_fwd = rec["forward_route"] == "pallas"
        rec["ok"] = (close and rec["route"] == "plain" and rec["k3_launches"] == 0
                     and kernel_fwd == (rec["k2_launches"] >= 1) == (dtype == torch.float32
                                                                     and jitter == "uniform"))
        emit(rec)
        check(rec["ok"], f"the plain replay on the card ({name}, {dtype}, {jitter})")
    emit({"phase": "geometry_phases", "seconds": time.perf_counter() - t_geo})

    # ---- 19-25. the host runtime and the benchmark suite ----
    t_host = time.perf_counter()
    host_runtime(dev, k2, k3)
    emit({"phase": "host_runtime_phases", "seconds": time.perf_counter() - t_host})

    # ---- 26-30. the mesh and multi-process paths ----
    t_par = time.perf_counter()
    parallel_paths(dev, k2, k3, k7, smi)
    emit({"phase": "parallel_phases", "seconds": time.perf_counter() - t_par})

    # ---- 31. parity_artifact ----
    parity_artifact(dev)

    # Beside each render kernel's published-peak bound, its operations at
    # the rates the probe just measured.
    for entry, ops in ((k2, k2_ops), (k3, k3_ops), (k4, k4_ops), (k7, k7_ops)):
        entry["probe_model_ms"] = roofline.probe_model_ms(ops, res)

    emit({"kernels": [k2, k3, k4, k5, k6, k7]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
