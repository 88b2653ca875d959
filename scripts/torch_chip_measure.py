#!/usr/bin/env python3
"""Measurements of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 scripts/torch_chip_measure.py
        [--part build|fmad|profile|scenes|train|step|probe|stream|simt|designs|geometry|
                geometry_designs|geometry_step|sharded|multicard|threads|all]
               [--baseline DIR]

Prints one JSON line per measurement, with the card's nvidia-smi line
(name, power limit, SM clock, power drawn) before and after.  The parts:

- build: wall seconds of the kernels' build from nothing in two forms, in
  the order parallel, single, parallel, single: ``_build.build`` (one
  ``nvcc -c`` per source, started together, then a link) and one ``nvcc``
  command over every source.  Each builds into its own directory under
  ``_build/``, removed afterwards.
- fmad: builds the kernel with and without ``-fmad=false`` and reports,
  for each, the per-item parity against the plain version at 64x48, 2 spp,
  max_depth 8 and 100 (six scenes), then the kernel's CUDA-event time on
  disco (box_mirror) 1024x768, 32 total spp, max_depth 100, in the order
  nofma, fma, nofma, fma (1 warm-up, 3 runs each).
- profile: ``torch.profiler`` over 3 ``render_cells_range`` calls of that
  main path: the window's event time, the device time by kernel and the
  share of the window the device was busy.
- scenes: the kernel's Mrays/s, segments per item and occupancy for every
  scene at the main path's size (1 warm-up, median of 3).
- train: the production inverse step (box 400x400, 64 total spp, max_depth
  100, albedo and emission, 131,072-cell chunks): the target's render time,
  a cProfile of the first step (the top functions by cumulative time), the
  second step's time, then ``torch.profiler`` over 3 steps as in profile.
- step: the per-step render of the main path (``cli bench``'s loop,
  ``ops/wavefront.drive_items`` with the per-step kernel).  By steps a
  launch (8, 1, 2, 4, 16, 32, 8): the loop's CUDA-event ms (1 warm-up, 3
  runs) with a batch replayed as a CUDA graph and launch by launch, the
  kernel's device ms and launches from ``torch.profiler``, and the
  lane-state bytes the design moves (``step_traffic``).  Then, at the
  module's steps a launch: the loop's sync every 16 launches and every 64,
  in the order 16, 64, 16, 64; the pool widths 2^17, 2^19 and 2^21 (ms,
  iterations, occupancy); the kernel's time per launch by pool occupancy
  (ten bins: launches, device ms, segments; what the drain tail costs); a
  cProfile of one render (host time by function); ``torch.profiler`` over
  3 renders as in profile.
- probe: the machine-constant probe (``scripts/torch_perf_probe.py``) three
  times in one process: each run's line, then each constant's least, median
  and greatest value and its spread, (greatest - least) / median; then the
  fma chain at 2,048, 8,192 and 32,768 iterations (what a launch costs
  beside its loop).
- stream: the designs of the device-memory stream ``y = 2x`` in
  ``scripts/torch_stream_designs.cu`` (a strided persistent grid, one tile
  a block in several shapes, persistent grids walking tiles, TMA bulk
  copies through a shared-memory ring), built with nvcc into ``_build/``,
  each held bitwise to ``2 * x`` at 2^26 float32 and timed in 5 rounds of
  20 launches with ``torch.mul(x, 2.0, out=y)`` before and after every
  round: least, median and greatest ms and the median's GB/s, fastest first.
- simt: the render kernels measuring themselves (the machine has no ncu or
  nsys).  Builds the kernels with ``-DPT_SIMT_PROBE`` (the sections of
  ``csrc/step_math.cuh``; the geometry replay's record, sweep and camera
  VJP too) and launches the forward kernel on the main path (disco
  1024x768, 32 spp, depth 100) and on one chunk of the production inverse
  step (box 400x400, 64 spp, 131,072 cells), and the replay and geometry
  replay kernels on that chunk, on a simple chunk of that size and on the
  geometry path's first chunk with its own cotangent.  Per section: the
  warp-level executions, the active lanes, the SIMT efficiency (lanes / (32
  x executions)), the SM cycles warps spent there and their share of the
  warps' whole stay in the kernel; then the launch's segments, occupancy
  and ms with the probe and, from the production build, without it.  Not
  part of ``all``.
- designs: the forward and replay kernels built with other numbers of idle
  lanes that make a warp refill (``-DPT_REFILL_MIN=n``, the one design
  parameter ``csrc/step_math.cuh`` leaves to the build), each held to the
  production build (forward ``out`` bitwise on disco and the box chunk;
  replay partials within the block limits of its plain version, two
  launches bitwise equal) and timed on the three launches of ``simt`` and on
  the replay kernel's other two buckets (smallpt, 10 spheres, and the first
  40 spheres of random_spheres, each on a chunk of the same size): median of
  3 kernel launches, with registers and spills from ptxas, segments and
  occupancy.  ``--variants a,b`` picks some.  Not part of ``all``.
- geometry: the backward of one 131,072-cell chunk of the production
  geometry step (box 400x400, 64 total spp, max_depth 100, p0, radius,
  albedo and emission) and of simple at that size on both routes of
  ``grad.backward_route``: 'geometry' (the geometry replay and replay
  kernels, all 16 samples) and 'scan' (``--no-replay-backward``, one
  recompute of one sample): wall ms of the span's forward and backward,
  ms a sample, peak memory, profiled
  launches, device ms and busy share; then the geometry replay kernel alone
  on each chunk (ms, segments, swept paths and bounces, bound).  About 1
  minute on an H100; not part of ``all``.
- geometry_designs: the geometry replay kernel against ``--baseline DIR``
  (another checkout's ``csrc``: the parent commit's, from ``git archive``)
  in one process, on simt's three chunks and one of each larger bucket
  (smallpt, simple with every sphere twice, 40 of random_spheres' spheres),
  the replay kernel beside them, timed in turns, the baseline held to this
  build's partials; registers and spills of both; then every other
  kernel's SASS against the baseline's.  About 2 minutes; not part of
  ``all``.
- geometry_step: the production geometry step as ``cli invert`` builds it
  on each route: 'geometry' (3 whole steps after a warm-up: ms, launches a
  step, one step profiled, then the step's gradient) and 'scan' (the
  step's gradient once: several minutes, not profiled): ms, loss, peak
  memory, the largest p0 and radius gradient, the paths that ended on a
  miss, and the two routes' gradients against each other.  About 7 minutes
  on an H100; not part of ``all``.
- sharded: the mesh paths on one card beside their one-device forms, in
  turns: the disco render one pass, on a 4x1 and on a 2x2 mesh of cuda:0,
  and the production inverse step on one device and on a 2x2 mesh, each a
  CUDA-event time and ``profile``'s breakdown over 3 calls.  About 30 s;
  not part of ``all``.
- multicard: the same paths over every visible card (a machine with
  several): the disco render on tiles-only meshes of 2, 4, ... distinct
  cards against one pass (bitwise, host ms), the production step on a
  2x(cards/2) mesh (a worker process a card) against one device (loss and
  gradients, ms a step),
  ``cli render`` with one rank a card (replicated and ``--shard-dir``:
  wall seconds, PNG bytes) and ``cli bench --scaling``.  Not part of
  ``all``.
- threads: host threads against one host thread: N threads issuing small
  torch calls or ``render_cells_range`` at once (microseconds a call, also
  pinned to one core), and the disco render's 4 shards on one card by
  ``spmd.run``, by a thread a shard and on one stream.  About 30 s; not
  part of ``all``.

Imports nothing of JAX.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import ctypes
import io
import json
import os
import pstats
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import cpu_path_tracing_tpu_torch as tp  # noqa: E402
from cpu_path_tracing_tpu_torch import _build, render  # noqa: E402
from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk  # noqa: E402
from cpu_path_tracing_tpu_torch.utils import profiling, roofline  # noqa: E402

MAIN = tp.RenderConfig(width=1024, height=768, spp=8, max_depth=100)
VARIANTS = {"nofma": _build.FLAGS, "fma": tuple(f for f in _build.FLAGS if f != "-fmad=false")}


OUT = None  # --out: a file that also gets every JSON line


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
    if OUT:
        with open(OUT, "a") as fh:
            fh.write(json.dumps(record) + "\n")


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


@contextlib.contextmanager
def kernel_variant(flags):
    """Make the wrapper launch the library built with ``flags``."""
    with kernel_variant_lib(_build.load(flags)):
        yield


@contextlib.contextmanager
def kernel_variant_lib(lib):
    """Make the wrapper launch ``lib``."""
    real = _build.load
    _build.load = lambda: lib
    try:
        yield
    finally:
        _build.load = real


def event_times(fn, runs: int = 3):
    """CUDA-event ms of ``runs`` calls after one warm-up; returns (times, last result)."""
    fn()
    times, out = [], None
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times, out


def packed(name, cfg, dev):
    scene = tp.get_scene(name, cfg.width, cfg.height)
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=cfg.spp * cfg.num_cells, ior=scene.ior)
    return mk.pack_scene(scene).to(dev), mk.pack_camera(scene).to(dev), kw


def part_build(dev):
    nvcc, real_dir = _build.find_nvcc(), _build.BUILD_DIR
    for form in ("parallel", "single", "parallel", "single"):
        out = real_dir / f"measure_{form}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        t0 = time.perf_counter()
        if form == "parallel":
            _build.BUILD_DIR = out
            try:
                _build.build()
            finally:
                _build.BUILD_DIR = real_dir
        else:
            subprocess.run([nvcc, *_build.ARCH_FLAGS, *_build.FLAGS, "-shared", "-o",
                            str(out / "lib.so"), *map(str, _build._sources())],
                           check=True, capture_output=True)
        emit({"build_form": form, "seconds": time.perf_counter() - t0,
              "sources": len(_build._sources())})
        shutil.rmtree(out)


def part_fmad(dev):
    for name, flags in VARIANTS.items():
        log = _build.build(flags).with_suffix(".log").read_text()
        emit({"variant": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                         if "registers" in ln or "spill" in ln]})
    for scene in ("box_mirror", "simple", "box", "smallpt", "random_spheres_512",
                  "depth_of_field"):
        for depth in (8, 100):
            cfg = tp.RenderConfig(width=64, height=48, spp=2, max_depth=depth)
            table, cam, kw = packed(scene, cfg, dev)
            ref = mk.persistent_render_reference(table, cam, (0, 0), **kw)[0].cpu().numpy()
            rec = {"scene": scene, "depth": depth}
            for name, flags in VARIANTS.items():
                with kernel_variant(flags):
                    got = mk.persistent_render(table, cam, (0, 0), **kw)[0].cpu().numpy()
                d = (np.abs(got - ref) / np.maximum(np.maximum(np.abs(got), np.abs(ref)), 1.0))
                d = d.max(axis=0)
                rec[name] = {"exact_frac": float(np.mean(got == ref)),
                             "p999": float(np.quantile(d, 0.999)),
                             "frac_above_1e-3": float(np.mean(d > 1e-3))}
            emit(rec)
    table, cam, kw = packed("box_mirror", MAIN, dev)
    for name in ("nofma", "fma", "nofma", "fma"):
        with kernel_variant(VARIANTS[name]):
            times, (_, st) = event_times(lambda: mk.persistent_render(table, cam, (0, 0), **kw))
        emit({"variant": name, "main_path_kernel_ms": times, "segments": int(st["segments"])})


def profiled(call, runs: int = 3) -> dict:
    """``torch.profiler`` over ``runs`` calls: the window's CUDA-event time,
    device time by kernel (``profiling.device_time_by_kernel``: device-side
    rows only), and the share of the window the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0.record()
        for _ in range(runs):
            call()
        e1.record()
        torch.cuda.synchronize()
    window_ms = e0.elapsed_time(e1)
    rows = sorted(((ms, n, key) for key, (ms, n) in
                   profiling.device_time_by_kernel(prof).items()), reverse=True)
    device_ms = sum(r[0] for r in rows)
    host = sorted(((k.self_cpu_time_total / 1e3, k.count, k.key) for k in prof.key_averages()
                   if k.device_type == torch.autograd.DeviceType.CPU), reverse=True)
    return {"calls": runs, "window_ms": window_ms, "device_ms": device_ms,
            "busy_share": device_ms / window_ms,
            "top": [{"ms": ms, "count": n, "name": key[:80]} for ms, n, key in rows[:12]],
            "top_host_self": [{"ms": ms, "count": n, "name": key[:80]}
                              for ms, n, key in host[:10]]}


def part_profile(dev):
    scene = tp.get_scene("box_mirror", MAIN.width, MAIN.height).to(dev)
    ids = torch.arange(MAIN.num_cells, device=dev)

    def call():
        return render.render_cells_range(scene, MAIN, ids, 0, MAIN.spp, with_stats=True)

    call()
    torch.cuda.synchronize()
    emit(profiled(call))


def part_train(dev):
    from cpu_path_tracing_tpu_torch import grad

    cfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    chunk = 1 << 17
    scene = tp.get_scene("box", cfg.width, cfg.height).to(dev)
    t0 = time.perf_counter()
    target = grad.render_target(scene, cfg, chunk)
    torch.cuda.synchronize()
    target_s = time.perf_counter() - t0
    state = {"params": {k: v + 0.02 for k, v in grad.split_params(
        scene, ("albedo", "emission")).items()}}
    step = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=chunk)

    def call():
        state["params"], loss = step(state["params"], target)
        return float(loss)

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    call()
    prof.disable()
    first_s = time.perf_counter() - t0
    top = pstats.Stats(prof).sort_stats("cumulative")
    rows = sorted(((v[3], v[1], f"{k[0].split('/')[-1]}:{k[1]}:{k[2]}")
                   for k, v in top.stats.items()), reverse=True)[:25]
    t0 = time.perf_counter()
    call()
    second_s = time.perf_counter() - t0
    emit({"train": "box 400x400, 64 total spp, max_depth 100, 5 chunks", "target_s": target_s,
          "first_step_s": first_s, "second_step_s": second_s,
          "first_step_top_cumulative": [{"s": c, "calls": n, "fn": f} for c, n, f in rows]})
    emit({"train_profile": profiled(call)})


def part_sharded(dev):
    """The mesh paths on one card beside their one-device forms, in turns
    (one device, mesh, mesh, one device): the disco render on a 4x1 and a
    2x2 mesh of cuda:0, and the production inverse step on a 2x2 mesh,
    each a CUDA-event time (1 warm-up, then 3 calls) and a profile over 3
    calls (``profiled``)."""
    from cpu_path_tracing_tpu_torch import grad
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh
    from cpu_path_tracing_tpu_torch.parallel.render import render_image_sharded

    scene = tp.get_scene("box_mirror", MAIN.width, MAIN.height).to(dev)
    renders = {"one_pass": lambda: tp.render_image(scene, MAIN)}
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh(*shape, [dev] * 4)
        renders[f"mesh_{shape[0]}x{shape[1]}"] = (
            lambda mesh=mesh: render_image_sharded(scene, MAIN, mesh))
    for name in ("one_pass", "mesh_4x1", "mesh_2x2", "mesh_2x2", "mesh_4x1", "one_pass"):
        times, _ = event_times(renders[name])
        emit({"sharded_render": name, "ms": times, "profile": profiled(renders[name])})

    cfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    chunk = 1 << 17
    box = tp.get_scene("box", cfg.width, cfg.height).to(dev)
    target = grad.render_target(box, cfg, chunk)
    p0 = {k: v + 0.02 for k, v in grad.split_params(box, ("albedo", "emission")).items()}
    steps = {"one_device": grad.make_accum_train_step(box, cfg, 1e-2, cell_chunk=chunk),
             "mesh_2x2": grad.make_sharded_accum_train_step(make_mesh(2, 2, [dev] * 4), box, cfg,
                                                            1e-2, cell_chunk=chunk)}
    for name in ("one_device", "mesh_2x2", "mesh_2x2", "one_device"):
        state = {"params": p0}

        def call(step=steps[name]):
            state["params"], _ = step(state["params"], target)

        times, _ = event_times(call)
        emit({"sharded_train": name, "step_ms": times, "profile": profiled(call)})


def part_threads(dev):
    """Host threads against one host thread.  (1) N threads (1, 2, 4, 8),
    each on a stream of its own, each making 4,000 in-place adds on a
    16-element tensor on the card, then the same on the CPU: microseconds a
    call over all calls, also with every thread pinned to one core.  (2) The
    same with ``render_cells_range`` of 64 cells on the card (its host
    path), 100 calls a thread.  (3) The disco render's 4 shards of a 4x1
    mesh of the card, each a ``render_cells_range`` call: ``spmd.run`` (one
    host thread, a stream a shard) against a thread a shard (the
    ``torch.nn.parallel.parallel_apply`` idiom, each thread on the shard's
    stream) and against one stream, CUDA-event ms (1 warm-up, 5 calls),
    the three bitwise equal."""
    import threading

    from cpu_path_tracing_tpu_torch.parallel import spmd
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh
    from cpu_path_tracing_tpu_torch.parallel.render import tile_span

    def threaded(n, work, device, pin):
        streams = [torch.cuda.Stream(device) if device.type == "cuda" else None
                   for _ in range(n)]
        barrier = threading.Barrier(n + 1)
        core = min(os.sched_getaffinity(0))

        def run(i):
            if pin:
                os.sched_setaffinity(0, {core})
            with (torch.cuda.stream(streams[i]) if streams[i] is not None
                  else contextlib.nullcontext()):
                prep = work(i, None)
                barrier.wait()
                return work(i, prep)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        barrier.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    def adds(device, n_ops=4000):
        def work(i, x):
            if x is None:
                return torch.zeros(16, device=device)
            for _ in range(n_ops):
                x.add_(1)
        return work, n_ops

    small_cfg = tp.RenderConfig(width=8, height=8, spp=1, max_depth=8)
    small = tp.get_scene("box", 8, 8).to(dev)

    def renders(device, n_calls=100):
        def work(i, ids):
            if ids is None:
                return torch.arange(64 * i, 64 * (i + 1), device=device)
            for _ in range(n_calls):
                render.render_cells_range(small, small_cfg, ids, 0, 1)
        return work, n_calls

    for name, make, devices in (("add_", adds, (dev, torch.device("cpu"))),
                                ("render_cells_range_64_cells", renders, (dev,))):
        for device in devices:
            for pin in (False, True):
                work, calls = make(device)
                threaded(2, work, device, pin)  # warm-up
                row = {"threads": name, "device": str(device), "pinned_one_core": pin}
                for n in (1, 2, 4, 8):
                    row[f"us_a_call_{n}_threads"] = 1e6 * threaded(n, work, device, pin) / (
                        n * calls)
                emit(row)

    scene = tp.get_scene("box_mirror", MAIN.width, MAIN.height).to(dev)
    mesh = make_mesh(4, 1, [dev] * 4)
    per = tile_span(MAIN, 4)
    ids = [torch.arange(t * per, (t + 1) * per, device=dev) for t in range(4)]

    def shard(t, s, d):
        return render.render_cells_range(scene, MAIN, ids[t], 0, MAIN.spp)

    def one_stream():
        return [shard(t, 0, dev) for t in range(4)]

    def runner():
        return [row[0] for row in spmd.run(mesh, shard)]

    def thread_a_shard():
        caller = torch.cuda.current_stream(dev)
        streams = [spmd.entry_stream(dev, t) for t in range(4)]
        out = [None] * 4

        def work(t):
            with torch.cuda.stream(streams[t]):
                out[t] = shard(t, 0, dev)

        for st in streams:
            st.wait_stream(caller)
        threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for st in streams:
            caller.wait_stream(st)
        return out

    ref = one_stream()
    for name, fn in (("one_stream", one_stream), ("spmd_run", runner),
                     ("thread_a_shard", thread_a_shard), ("thread_a_shard", thread_a_shard),
                     ("spmd_run", runner), ("one_stream", one_stream)):
        times, out = event_times(fn, runs=5)
        emit({"threads": "disco_4x1_shards", "runner": name, "ms": times,
              "bitwise": all(torch.equal(a, b) for a, b in zip(out, ref))})


def part_multicard(dev):
    """The mesh and multi-process paths over every visible card (run it on
    a machine with several): the disco render one pass on cuda:0 and on
    tiles-only meshes of 2, 4, ... distinct cards (bitwise against the one
    pass; host seconds, each call ended by a synchronize of every card, 1
    warm-up, 3 calls), the production inverse step on cuda:0 and on a
    2x(cards/2) mesh of distinct cards (the first step's loss and gradients
    against one device; steps/s), ``cli render`` over one rank a card
    (replicated and ``--shard-dir``; wall seconds, PNG bytes against one
    process), and ``cli bench --scaling``."""
    import tempfile

    from cpu_path_tracing_tpu_torch import cli, grad
    from cpu_path_tracing_tpu_torch.parallel.mesh import make_mesh
    from cpu_path_tracing_tpu_torch.parallel.render import render_image_sharded

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    def host_ms(fn):
        fn()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            for d in cards:
                torch.cuda.synchronize(d)
            times.append(1e3 * (time.perf_counter() - t0))
        return times

    scene = tp.get_scene("box_mirror", MAIN.width, MAIN.height).to(dev)
    ref = tp.render_image(scene, MAIN)
    emit({"multicard_render": "one_pass", "cards": 1,
          "ms": host_ms(lambda: tp.render_image(scene, MAIN))})
    n = 2
    while n <= len(cards):
        mesh = make_mesh(n, 1, cards[:n])
        img = render_image_sharded(scene, MAIN, mesh)
        emit({"multicard_render": f"mesh_{n}x1", "cards": n,
              "bitwise": bool(torch.equal(img.to(dev), ref)),
              "ms": host_ms(lambda: render_image_sharded(scene, MAIN, mesh))})
        n *= 2

    cfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    chunk = 1 << 17
    box = tp.get_scene("box", cfg.width, cfg.height).to(dev)
    target = grad.render_target(box, cfg, chunk)
    p0 = {k: v + 0.02 for k, v in grad.split_params(box, ("albedo", "emission")).items()}
    l1, g1 = grad.make_accum_loss_grad(box, cfg, cell_chunk=chunk)(p0, target)
    if len(cards) >= 2:
        mesh = make_mesh(len(cards) // 2, 2, cards[:len(cards) // 2 * 2])
        l2, g2 = grad.make_sharded_accum_loss_grad(mesh, box, cfg, cell_chunk=chunk)(p0, target)
        dev_rec = {"loss_rel_dev": abs(float(l2) - float(l1)) / float(l1),
                   "grad_dev_over_max": {k: float((g2[k].to(dev) - g1[k]).abs().max())
                                         / float(g1[k].abs().max()) for k in g1}}
        for name, step in (("one_device", grad.make_accum_train_step(box, cfg, 1e-2,
                                                                      cell_chunk=chunk)),
                           (f"mesh_{mesh.shape['tiles']}x2", grad.make_sharded_accum_train_step(
                               mesh, box, cfg, 1e-2, cell_chunk=chunk))):
            state = {"params": p0}

            def call(step=step):
                state["params"], _ = step(state["params"], target)

            emit({"multicard_train": name, "step_ms": host_ms(call), **dev_rec})

    work = tempfile.mkdtemp(prefix="multicard_")
    disco = ["--scene", "box_mirror", "--width", "1024", "--height", "768", "--total-spp", "32",
             "--max-depth", "100"]
    one = os.path.join(work, "one.png")
    cli.main(["render", *disco, "-o", one])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    for mode, extra in (("replicated", []), ("shard_dir", ["--shard-dir",
                                                           os.path.join(work, "shards")])):
        png = os.path.join(work, f"{mode}.png")
        argv = [sys.executable, "-m", "cpu_path_tracing_tpu_torch.cli", "render", *disco,
                "--num-processes", str(len(cards)), "--coordinator",
                f"127.0.0.1:{free_port()}", "-o", png, *extra]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([*argv, "--process-id", str(r)], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(len(cards))]
        rcs = []
        try:
            for proc in procs:
                proc.communicate(timeout=300)
                rcs.append(proc.returncode)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        emit({"multicard_processes": mode, "ranks": len(cards), "rcs": rcs,
              "wall_s": time.perf_counter() - t0,
              "png_equal": os.path.exists(png) and open(png, "rb").read() == open(one,
                                                                                  "rb").read()})
    shutil.rmtree(work, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["bench", "--scaling", *disco])
    for ln in buf.getvalue().splitlines():
        emit({"multicard_scaling": json.loads(ln)})


def free_port() -> int:
    """A free TCP port on this host."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


GEOMETRY_CFG = dict(width=400, height=400, spp=16, max_depth=100)
GEOMETRY_CHUNK = 1 << 17
GEOMETRY_FIELDS = ("p0", "radius", "albedo", "emission")


def _profiled(fn):
    """``fn()`` once under ``torch.profiler``: (window ms, device ms, busy
    share, launches)."""
    from torch.profiler import ProfilerActivity, profile

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
    window_ms = e0.elapsed_time(e1)
    by_kernel = profiling.device_time_by_kernel(prof)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    return {"window_ms": window_ms, "device_ms": device_ms, "busy_share": device_ms / window_ms,
            "launches": sum(n for _, n in by_kernel.values())}


def part_geometry(dev):
    """The backward of one 131,072-cell chunk of the production geometry
    step (box 400x400, 64 total spp, max_depth 100, p0, radius, albedo and
    emission) and of the same chunk of simple, on both routes of
    ``grad.backward_route``: 'geometry' (the geometry replay and the replay
    kernels, all 16 samples in one launch each) and 'scan' (``replay=False``:
    one recompute of one sample, the module's compaction and loop, after a
    warm-up).  Each: wall ms of the span's forward and backward (ended by a
    sync), ms a sample, peak memory, and under ``torch.profiler`` launches,
    device ms and busy share.  Then
    the geometry replay kernel alone on each chunk: CUDA-event ms (1
    warm-up, median of 3), segments, swept paths and bounces, and its
    bound."""
    from cpu_path_tracing_tpu_torch import grad
    from cpu_path_tracing_tpu_torch.ops.kernels import geometry_replay as gk

    cfg = tp.RenderConfig(**GEOMETRY_CFG)
    ids = torch.arange(GEOMETRY_CHUNK, device=dev)
    ct = torch.ones((GEOMETRY_CHUNK, 3), device=dev)
    for name in ("box", "simple"):
        scene = tp.get_scene(name, cfg.width, cfg.height).to(dev)
        start = {k: v + 0.02 for k, v in grad.split_params(scene, GEOMETRY_FIELDS).items()}
        for route, replay, spp in (("geometry", True, cfg.spp), ("scan", False, 1)):
            render_sum = grad.make_diff_render_span(scene, cfg, spp, 1, replay=replay)
            assert render_sum.span.route(GEOMETRY_FIELDS) == route

            def backward():
                names, values = grad.flatten_params(start)
                leaves = [v.detach().requires_grad_(True) for v in values]
                out = render_sum(grad.unflatten_params(names, leaves), ids, 0)
                g = torch.autograd.grad(out, leaves, grad_outputs=ct)
                torch.cuda.synchronize()
                return g

            backward()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            backward()
            wall_ms = (time.perf_counter() - t0) * 1e3
            emit({"geometry_chunk": f"{name} 400x400, max_depth 100, "
                                    "p0,radius,albedo,emission, a 131072-cell chunk",
                  "route": route, "samples": spp, "wall_ms": wall_ms,
                  "ms_per_sample": wall_ms / spp,
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "profiled": _profiled(backward), "smi": smi()})
        table, cam = mk.pack_scene(scene), mk.pack_camera(scene)
        kw = dict(cfg=cfg, n_cells=GEOMETRY_CHUNK, n_items=cfg.spp * GEOMETRY_CHUNK, ior=scene.ior)
        times, (part, st) = event_times(lambda: gk.geometry_replay(table, cam, (0, 0), ct, **kw))
        seg, sweep, missed = (int(st[k]) for k in ("segments", "sweep_bounces", "missed"))
        ops = roofline.geometry_ops(scene.num_spheres, seg, kw["n_items"], sweep, missed)
        nbytes = (roofline.geometry_record_bytes(seg, sweep, kw["n_items"])
                  + 4 * (ct.numel() + table.numel() + cam.numel() + part.numel()))
        bound, by = roofline.bound_ms(nbytes, ops.issues())
        emit({"geometry_kernel": f"{name} 400x400, 16 spp, max_depth 100, 131072 cells",
              "ms": sorted(times)[1], "runs_ms": times, "items": kw["n_items"], "segments": seg,
              "missed": missed, "sweep_bounces": sweep, "lanes": st["lanes"],
              "bound_ms": bound, "bound_by": by, "record_gb": nbytes / 1e9, "smi": smi()})


def part_geometry_step(dev):
    """The production geometry step (box 400x400, 64 total spp, max_depth
    100, p0, radius, albedo and emission from +0.02, 131,072-cell chunks,
    as ``cli invert`` builds it) on each route.  'geometry': a warm-up,
    then 3 whole steps (``make_accum_train_step``; wall ms each, ended by a
    sync), the three kernels' launches a step, peak memory, one step under
    ``torch.profiler``, and the step's gradient (``make_accum_loss_grad``).
    'scan' (``--no-replay-backward``): the step's gradient once, timed (the
    step less Adam's update; several minutes), with peak memory; no profiler
    (a step is ~12 M launches: ``part_geometry`` profiles one recompute).
    Then each route's largest p0 and radius gradient, the paths that ended
    on a miss (the geometry replay's count: only they carry one; the box
    is closed, and a float32 ray that slips through a seam is the rare
    exception) and the two routes' p0, radius, albedo and emission
    gradients against each other."""
    from cpu_path_tracing_tpu_torch import grad
    from cpu_path_tracing_tpu_torch.ops.kernels import geometry_replay as gk
    from cpu_path_tracing_tpu_torch.ops.kernels import replay as rk

    cfg = tp.RenderConfig(**GEOMETRY_CFG)
    scene = tp.get_scene("box", cfg.width, cfg.height).to(dev)
    start = {k: v + 0.02 for k, v in grad.split_params(scene, GEOMETRY_FIELDS).items()}
    target = grad.render_target(scene, cfg, GEOMETRY_CHUNK)
    kw = dict(cell_chunk=GEOMETRY_CHUNK, sample_chunk=1)

    def launches():
        return (mk.persistent_render.launches, rk.replay_persistent.launches,
                gk.geometry_replay.launches)

    grads = {}
    for route, replay in (("geometry", True), ("scan", False)):
        loss_grad = grad.make_accum_loss_grad(scene, cfg, replay=replay, **kw)
        assert loss_grad.span.route(GEOMETRY_FIELDS) == route
        rec = {"geometry_step": "box 400x400, 64 total spp, max_depth 100, "
                                "p0,radius,albedo,emission from +0.02, sample_chunk 1, "
                                "131072-cell chunks", "route": route}
        if route == "geometry":
            step = grad.make_accum_train_step(scene, cfg, 1e-2, **kw)
            params, _ = step(start, target)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_ms = []
            for _ in range(3):
                before = launches()
                t0 = time.perf_counter()
                params, loss = step(params, target)
                loss = float(loss)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            rec.update(step_ms=step_ms, loss=loss,
                       launches_per_step=dict(zip(("k2", "k3", "k7"),
                                                  (a - b for a, b in zip(launches(), before)))),
                       profiled=_profiled(lambda: step(params, target)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launches()
        t0 = time.perf_counter()
        loss, g = loss_grad(start, target)
        loss = float(loss)
        rec.update(gradient_ms=(time.perf_counter() - t0) * 1e3, gradient_loss=loss,
                   gradient_launches=dict(zip(("k2", "k3", "k7"),
                                              (a - b for a, b in zip(launches(), before)))),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   max_abs={k: float(v.abs().max()) for k, v in g.items()}, smi=smi())
        if route == "geometry":
            # The step's paths that ended on a miss, counted by the geometry
            # replay chunk by chunk at the same parameters.
            sc = grad.merge_params(scene, start)
            table, cam = mk.pack_scene(sc), mk.pack_camera(sc)
            ones = torch.ones((GEOMETRY_CHUNK, 3), device=dev)
            rec["missed_paths"] = 0
            for c0 in range(0, cfg.num_cells, GEOMETRY_CHUNK):
                n = min(GEOMETRY_CHUNK, cfg.num_cells - c0)
                _, st = gk.geometry_replay(table, cam, (c0, 0), ones[:n], cfg=cfg, n_cells=n,
                                           n_items=cfg.spp * n, ior=sc.ior)
                rec["missed_paths"] += int(st["missed"])
        else:
            rec["recomputes"] = -(-cfg.num_cells // GEOMETRY_CHUNK) * cfg.spp
        grads[route] = g
        emit(rec)
    emit({"geometry_step_routes": "the geometry route's gradients against the scan route's",
          "max_abs_diff": {k: float((grads["geometry"][k] - grads["scan"][k]).abs().max())
                           for k in GEOMETRY_FIELDS},
          "scan_max_abs": {k: float(grads["scan"][k].abs().max()) for k in GEOMETRY_FIELDS},
          "smi": smi()})


@contextlib.contextmanager
def steps_per_launch(steps: int):
    """Run the per-step loop with ``steps`` steps a launch."""
    from cpu_path_tracing_tpu_torch.ops import wavefront

    module_steps = wavefront.STEPS_PER_LAUNCH
    wavefront.STEPS_PER_LAUNCH = steps
    try:
        yield
    finally:
        wavefront.STEPS_PER_LAUNCH = module_steps


def step_traffic(scene, cfg, ids, sample_start: int, num_samples: int, lanes=None) -> dict:
    """One per-step render launch by launch, counting around every launch
    what decides the design's lane-state traffic: the lanes alive before
    and after it and the gen and alive words it changed.  Returns the
    loop's ``out`` and stats, the per-launch segment counts, and the bytes
    by ``roofline.lane_state_bytes``."""
    from cpu_path_tracing_tpu_torch.ops import wavefront

    tally = torch.zeros(3, dtype=torch.int64, device=scene.device)
    per_launch = []

    def counted(state, *args, seg, seg_slot, steps, **kw):
        before = state.i[3:].clone()
        mk.megakernel_step(state, *args, seg=seg, seg_slot=seg_slot, steps=steps, **kw)
        tally[0] += before[1].sum()
        tally[1] += state.i[4].sum()
        tally[2] += (state.i[3:] != before).sum()
        per_launch.append(seg[seg_slot:seg_slot + steps].sum())

    out, st = wavefront.drive_items(counted, scene, cfg, ids, sample_start, num_samples, lanes)
    carried_in, carried_out, changed = (int(v) for v in tally)
    launches = len(per_launch)
    n_items = num_samples * int(ids.shape[0])
    return {"out": out, "stats": st, "launches": launches, "carried_in": carried_in,
            "carried_out": carried_out, "words_changed": changed,
            "segments_per_launch": [int(v) for v in torch.stack(per_launch).tolist()],
            "state_bytes": roofline.lane_state_bytes(st["lanes"], launches, carried_in,
                                                     carried_out, changed, n_items)}


def part_step(dev):
    from torch.profiler import ProfilerActivity, profile

    from cpu_path_tracing_tpu_torch.ops import wavefront

    scene = tp.get_scene("box_mirror", MAIN.width, MAIN.height).to(dev)
    ids = torch.arange(MAIN.num_cells, device=dev)

    def one_by_one(*args, **kw):  # not the wrapper itself: the loop launches one by one
        mk.megakernel_step(*args, **kw)

    def call(lanes=None, step=mk.megakernel_step):
        return wavefront.drive_items(step, scene, MAIN, ids, 0, MAIN.spp, lanes)

    for steps in (8, 1, 2, 4, 16, 32, 8):
        with steps_per_launch(steps):
            graph_ms, (_, st) = event_times(call)
            eager_ms, _ = event_times(lambda: call(step=one_by_one))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            per_launch = profiling.device_kernel_ms(prof, "megakernel_step_kernel")
            traffic = step_traffic(scene, MAIN, ids, 0, MAIN.spp)
        emit({"steps_per_launch": steps, "graph_loop_ms": graph_ms,
              "launch_by_launch_loop_ms": eager_ms, "launches": len(per_launch),
              "k4_device_ms": sum(per_launch), "k4_us_per_launch": 1e3 * sum(per_launch)
              / len(per_launch), "iters": st["iters"], "segments": st["segments"],
              "state_gb": traffic["state_bytes"] / 1e9,
              "state_floor_ms": traffic["state_bytes"] / roofline.PEAK_BYTES_PER_S * 1e3})
    batch = wavefront.STEP_BATCH
    try:
        for b in (16, 64, 16, 64):
            wavefront.STEP_BATCH = b
            times, (_, st) = event_times(call)
            emit({"step_batch": b, "ms": times, "iters": st["iters"]})
    finally:
        wavefront.STEP_BATCH = batch
    for lanes in (1 << 17, 1 << 19, 1 << 21):
        times, (_, st) = event_times(lambda: call(lanes))
        emit({"lanes": lanes, "ms": times, "iters": st["iters"], "segments": st["segments"],
              "occupancy": st["segments"] / (st["iters"] * lanes)})
    # The kernel's time by pool occupancy: the launches of one render in the
    # order they ran, each with the share of its lane-steps that were live.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traffic = step_traffic(scene, MAIN, ids, 0, MAIN.spp)
        torch.cuda.synchronize()
    per_launch = profiling.device_kernel_ms(prof, "megakernel_step_kernel")
    lane_steps = wavefront.STEPS_PER_LAUNCH * traffic["stats"]["lanes"]
    bins = [{"occupancy": f"{k / 10:.1f}-{(k + 1) / 10:.1f}", "launches": 0, "ms": 0.0,
             "segments": 0} for k in range(10)]
    for ms, segments in zip(per_launch, traffic["segments_per_launch"], strict=True):
        b = bins[min(9, int(10 * segments / lane_steps))]
        b["launches"] += 1
        b["ms"] += ms
        b["segments"] += segments
    emit({"k4_by_pool_occupancy": bins, "steps_per_launch": wavefront.STEPS_PER_LAUNCH,
          "launches": len(per_launch), "k4_device_ms": sum(per_launch),
          "empty_launches": sum(1 for v in traffic["segments_per_launch"] if v == 0),
          "empty_launch_ms": sum(ms for ms, v in zip(per_launch, traffic["segments_per_launch"])
                                 if v == 0)})
    prof = cProfile.Profile()
    prof.enable()
    call()
    torch.cuda.synchronize()
    prof.disable()
    top = pstats.Stats(prof)
    rows = sorted(((v[2], v[1], f"{k[0].split('/')[-1]}:{k[1]}:{k[2]}")
                   for k, v in top.stats.items()), reverse=True)[:15]
    emit({"step_render_top_host_self": [{"s": t, "calls": n, "fn": f} for t, n, f in rows]})
    emit({"step_profile": profiled(call)})


def part_probe(dev):
    import torch_perf_probe as tpp  # beside this script

    runs = [tpp.probe() for _ in range(3)]
    for r in runs:
        emit({"probe_run": r})
    spread = {}
    for key in (*tpp.RATE_KEYS.values(), "mem_stream_gbps", "mem_kernel_stream_gbps"):
        lo, mid, hi = sorted(r[key] for r in runs)
        spread[key] = {"least": lo, "median": mid, "greatest": hi, "spread": (hi - lo) / mid}
    emit({"probe_spread": spread, "issues_per_op": runs[0]["issues_per_op"]})
    from cpu_path_tracing_tpu_torch.ops.kernels import probe as pk

    xs = torch.ones((8, tpp.FULL_N), device=dev)
    for iters in (2048, 8192, 32768):
        ms = tpp.time_ms(lambda: pk.op_chain(xs, "fma", iters), 10)
        rate = xs.numel() * iters / (ms / 1e3)
        emit({"fma_chains": 8, "iters": iters, "ms": ms, "gops": rate / 1e9,
              "share_of_peak": rate / roofline.PEAK_FP32_ISSUES_PER_S})


def part_stream(dev):
    import torch_perf_probe as tpp  # beside this script

    here = os.path.dirname(os.path.abspath(__file__))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "stream_designs.so"
    subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.FLAGS, "-shared", "-o",
                    str(so), os.path.join(here, "torch_stream_designs.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.design_run.argtypes = [ctypes.c_int, vp, vp, ctypes.c_longlong, ctypes.c_float, vp]
    lib.design_run.restype = ctypes.c_int
    lib.design_name.argtypes = [ctypes.c_int]
    lib.design_name.restype = ctypes.c_char_p
    names = []
    while lib.design_name(len(names)):
        names.append(lib.design_name(len(names)).decode())
    n = tpp.STREAM_N
    x = torch.arange(n, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    want = x * 2.0

    def run(v):
        err = lib.design_run(v, x.data_ptr(), y.data_ptr(), n, 2.0,
                             torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"design {names[v]!r} launch failed ({err})")

    def library():
        torch.mul(x, 2.0, out=y)

    for v, name in enumerate(names):
        y.zero_()
        run(v)
        torch.cuda.synchronize()
        if not torch.equal(y, want):
            raise AssertionError(f"design {name!r} is not 2 * x")
    times = {name: [] for name in ("torch.mul", *names)}
    for _ in range(5):
        times["torch.mul"].append(tpp.time_ms(library, 20))
        for v, name in enumerate(names):
            times[name].append(tpp.time_ms(lambda: run(v), 20))
        times["torch.mul"].append(tpp.time_ms(library, 20))
    rows = []
    for name, ts in times.items():
        ts = sorted(ts)
        rows.append({"design": name, "least_ms": ts[0], "median_ms": ts[len(ts) // 2],
                     "greatest_ms": ts[-1], "median_gbps": 2 * 4 * n / ts[len(ts) // 2] / 1e6})
    emit({"stream_designs": sorted(rows, key=lambda r: r["median_ms"]), "n": n,
          "bitwise_equal_to_2x": True})


SECTIONS = ("regen", "intersect", "miss", "shade", "roulette", "diffuse", "specular",
            "dielectric", "update", "retire", "accumulate", "record", "sweep", "camera", "warp")
SIMT_FLAGS = (*_build.FLAGS, "-DPT_SIMT_PROBE")


def simt_base(kernel: str) -> int:
    """The probe's first word in ``counters``: pt::kSimtBase, or after the
    geometry replay's own counters."""
    from cpu_path_tracing_tpu_torch.ops.kernels.geometry_replay import GEOMETRY_COUNTER_WORDS

    return GEOMETRY_COUNTER_WORDS if kernel == "geometry" else 4


def simt_launch(lib, kernel: str, table, cam, dyn, cfg, n_cells: int, n_items: int, ior, ct=None):
    """One launch of ``kernel`` ('forward', 'replay' or 'geometry') from
    ``lib`` with a ``counters`` buffer wide enough for the probe's sums.
    Returns (counters as a list of ints, lanes, CUDA-event ms)."""
    from cpu_path_tracing_tpu_torch.ops.geometry_replay import n_geometry_partials
    from cpu_path_tracing_tpu_torch.ops.kernels.geometry_replay import RECORD_WORDS
    from cpu_path_tracing_tpu_torch.ops.replay import n_partials

    dev, n = table.device, table.shape[0]
    params = mk.launch_params(cfg, dyn, n_spheres=n, n_cells=n_cells, n_items=n_items, ior=ior)
    counters = torch.zeros(simt_base(kernel) + 3 * len(SECTIONS), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if kernel == "forward":
        out = torch.empty((3, n_items), dtype=torch.float32, device=dev)
        lanes = ctypes.c_longlong(0)
        a.record()
        err = lib.pt_persistent_render(table.data_ptr(), cam.data_ptr(), out.data_ptr(),
                                       counters.data_ptr(), ctypes.addressof(params),
                                       mk.index_bits(params), ctypes.byref(lanes), stream)
        b.record()
        lanes = lanes.value
    elif kernel == "geometry":
        blocks, threads = ctypes.c_longlong(0), ctypes.c_int(0)
        bits = mk.index_bits(params)
        err = lib.pt_geometry_grid(n, ctypes.c_longlong(n_items), bits, ctypes.byref(blocks),
                                   ctypes.byref(threads))
        if err != 0:
            raise RuntimeError(f"geometry grid query failed ({err})")
        rows = torch.zeros((blocks.value, n_geometry_partials(n)), dtype=torch.float32,
                           device=dev)
        rec = torch.empty(cfg.max_depth * RECORD_WORDS * blocks.value * threads.value,
                          dtype=torch.float32, device=dev)
        a.record()
        err = lib.pt_geometry_replay(table.data_ptr(), cam.data_ptr(), ct.data_ptr(),
                                     rows.data_ptr(), rec.data_ptr(), counters.data_ptr(),
                                     ctypes.addressof(params), bits, blocks.value, stream)
        b.record()
        lanes = blocks.value * threads.value
    else:
        blocks, threads = ctypes.c_longlong(0), ctypes.c_int(0)
        bits = mk.index_bits(params)
        err = lib.pt_replay_grid(n, ctypes.c_longlong(n_items), bits, ctypes.byref(blocks),
                                 ctypes.byref(threads))
        if err != 0:
            raise RuntimeError(f"replay grid query failed ({err})")
        rows = torch.zeros((blocks.value, n_partials(n)), dtype=torch.float32, device=dev)
        a.record()
        err = lib.pt_replay_persistent(table.data_ptr(), cam.data_ptr(), ct.data_ptr(),
                                       rows.data_ptr(), counters.data_ptr(),
                                       ctypes.addressof(params), bits, blocks.value, stream)
        b.record()
        lanes = blocks.value * threads.value
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {lib.pt_error_string(err).decode()} ({err})")
    torch.cuda.synchronize()
    return [int(v) for v in counters.tolist()], lanes, a.elapsed_time(b)


def simt_table(counters, base: int) -> dict:
    """The probe's sums per section (from word ``base``), with each
    section's SIMT efficiency and its share of the cycles warps spent in the
    kernel."""
    rows = {name: counters[base + 3 * k:base + 3 * k + 3] for k, name in enumerate(SECTIONS)}
    warp_cycles = rows["warp"][2]
    out = {}
    for name, (execs, lanes, cycles) in rows.items():
        if execs:
            out[name] = {"executions": execs, "active_lanes": lanes,
                         "simt_efficiency": lanes / (32 * execs), "cycles": cycles,
                         "share_of_warp_cycles": cycles / warp_cycles if warp_cycles else None}
    measured = sum(v["cycles"] for k, v in out.items() if k != "warp")
    out["unattributed_share"] = 1 - measured / warp_cycles if warp_cycles else None
    return out


def geometry_step_chunk(dev):
    """The first chunk of ``chip_smoke.py``'s geometry path (simple 400x400,
    16 samples a span, max_depth 100; p0, radius, albedo and camera at
    ``cli invert``'s seeded start, before a step) and its own cotangent,
    the loss's: (table, cam, ct)."""
    from cpu_path_tracing_tpu_torch import cli, grad

    cfg = tp.RenderConfig(**GEOMETRY_CFG)
    scene = tp.get_scene("simple", cfg.width, cfg.height).to(dev)
    target = grad.render_target(scene, cfg, GEOMETRY_CHUNK)
    true = grad.split_params(scene, ("p0", "radius", "albedo", "camera"))
    sc = grad.merge_params(scene, cli.perturbed_params(true, 0, 0.05))
    ids = torch.arange(GEOMETRY_CHUNK, device=dev)
    with torch.no_grad():
        ct = (2.0 * (render.render_cells_range(sc, cfg, ids, 0, cfg.spp) / cfg.spp
                     - target[:GEOMETRY_CHUNK]) / cfg.spp).contiguous()
    return mk.pack_scene(sc), mk.pack_camera(sc), ct


def part_simt(dev):
    """The probe build's sections and the production build's time of each
    launch: the forward kernel on disco and on a box chunk; the replay and
    the geometry replay kernels side by side on a box chunk, a simple chunk
    (both with a seeded normal cotangent) and the geometry path's first
    chunk with its own."""
    probe_lib, plain_lib = _build.load(SIMT_FLAGS), _build.load()
    log = _build.build(SIMT_FLAGS).with_suffix(".log").read_text()
    emit({"simt_build_ptxas": [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln][:40]})
    box_cfg = tp.RenderConfig(**GEOMETRY_CFG)
    chunk = GEOMETRY_CHUNK
    n_items = box_cfg.spp * chunk
    ct = torch.from_numpy(np.random.default_rng(11).normal(0, 1, (chunk, 3))
                          .astype(np.float32)).to(dev)
    cases = []
    table, cam, kw = packed("box_mirror", MAIN, dev)
    cases.append(("disco 1024x768, 32 spp, depth 100", "forward", table, cam, MAIN,
                  kw["n_cells"], kw["n_items"], kw["ior"], ct))
    for name in ("box", "simple"):
        table, cam, kw = packed(name, box_cfg, dev)
        what = f"{name} 400x400 chunk of 131,072 cells, 16 samples, depth 100"
        for kernel in (("forward", "replay", "geometry") if name == "box"
                       else ("replay", "geometry")):
            cases.append((what, kernel, table, cam, box_cfg, chunk, n_items, kw["ior"], ct))
    table, cam, step_ct = geometry_step_chunk(dev)
    for kernel in ("replay", "geometry"):
        cases.append(("the geometry path's first chunk (simple 400x400, 131,072 cells, 16 "
                      "samples, depth 100) with its own cotangent", kernel, table, cam, box_cfg,
                      chunk, n_items, 2.0, step_ct))
    for what, kernel, table, cam, cfg, n_cells, n_items, ior, cot in cases:
        args = (kernel, table, cam, (0, 0), cfg, n_cells, n_items, ior, cot)
        simt_launch(probe_lib, *args)  # warm-up
        counters, lanes, probe_ms = simt_launch(probe_lib, *args)
        simt_launch(plain_lib, *args)
        plain = [simt_launch(plain_lib, *args) for _ in range(3)]
        segments, iters = plain[0][0][0], plain[0][0][1]
        rec = {"simt": what, "kernel": kernel, "spheres": int(table.shape[0]),
               "n_items": n_items, "segments": segments, "segments_per_item": segments / n_items,
               "iters": iters, "lanes": lanes, "occupancy": segments / (iters * lanes),
               "probe_segments": counters[0], "ms_with_probe": probe_ms,
               "ms_production_build": sorted(ms for _, _, ms in plain),
               "sections": simt_table(counters, simt_base(kernel)), "smi": smi()}
        if kernel == "geometry":
            rec.update(sweep_bounces=plain[0][0][2], missed=plain[0][0][4])
        emit(rec)


DESIGNS = {"production": (),
           **{f"refill_{n}": (f"-DPT_REFILL_MIN={n}",) for n in (1, 4, 8, 12, 16, 32)}}


def render_kernel_ptxas(flags, kernels=("persistent_render", "replay_kernel"), log=None) -> dict:
    """Registers and spill line of every instantiation of ``kernels`` (the
    forward and replay kernels by default) in the build log of ``flags``, or
    in the build log at path ``log``."""
    log = (log or _build.build(flags).with_suffix(".log")).read_text().splitlines()
    out, name = {}, None
    for ln in log:
        if "Compiling entry function" in ln:
            name = roofline.kernel_label(ln.split("'")[1])
        elif name and "spill" in ln:
            out.setdefault(name, {})["spills"] = ln.strip()
        elif name and "registers" in ln:
            out.setdefault(name, {})["registers"] = int(ln.split("Used ")[1].split(" registers")[0])
    return {k: v for k, v in out.items() if k.startswith(tuple(kernels))}


def first_spheres(name: str, n: int, cfg):
    """The scene ``name`` cut to its first ``n`` spheres (the replay kernel
    takes at most 40; no registered scene has between 11 and 40)."""
    full = tp.get_scene(name, cfg.width, cfg.height)
    spheres = [(float(full.radius[i]),
                (full.p0[i] - full.radius[i] * full.anchor_dir[i]).tolist(),
                full.emission[i].tolist(), full.albedo[i].tolist(), int(full.material[i]))
               for i in range(n)]
    return tp.scene_from_spheres(spheres, full.camera, background=full.background.tolist(),
                                 ior=full.ior)


def part_designs(dev, names=None):
    from cpu_path_tracing_tpu_torch.ops.kernels import replay as rk
    from cpu_path_tracing_tpu_torch.ops.replay import partial_blocks

    box_cfg = tp.RenderConfig(width=400, height=400, spp=16, max_depth=100)
    chunk = 1 << 17
    disco = packed("box_mirror", MAIN, dev)
    box = packed("box", box_cfg, dev)
    chunk_kw = dict(cfg=box_cfg, n_cells=chunk, n_items=box_cfg.spp * chunk)
    box_kw = dict(chunk_kw, ior=box[2]["ior"])
    ct = torch.from_numpy(np.random.default_rng(11).normal(0, 1, (chunk, 3))
                          .astype(np.float32)).to(dev)
    want = {"disco": mk.persistent_render(disco[0], disco[1], (0, 0), **disco[2])[0],
            "box": mk.persistent_render(box[0], box[1], (0, 0), **box_kw)[0]}
    # The replay kernel's three buckets: box (8 spheres), smallpt (10: the
    # bucket of 16) and the first 40 spheres of random_spheres, each on a
    # chunk of the production inverse step's size, each with its plain
    # version's partials.
    forty = first_spheres("random_spheres", 40, box_cfg)
    smallpt = tp.get_scene("smallpt", box_cfg.width, box_cfg.height)
    replays = {"k3_box_chunk": (box[0], box[1], box_kw)}
    for what, scene in (("k3_smallpt_chunk", smallpt), ("k3_40_spheres_chunk", forty)):
        replays[what] = (mk.pack_scene(scene).to(dev), mk.pack_camera(scene).to(dev),
                         dict(chunk_kw, ior=scene.ior))
    refs = {what: rk.replay_persistent_reference(table, cam, (0, 0), ct, **kw)
            for what, (table, cam, kw) in replays.items()}
    for name in names or DESIGNS:
        flags = (*_build.FLAGS, *DESIGNS[name])
        t0 = time.perf_counter()
        lib = _build.load(flags)
        build_s = time.perf_counter() - t0
        rec = {"design": name, "flags": list(DESIGNS[name]), "build_s": build_s,
               "ptxas": render_kernel_ptxas(flags)}
        with kernel_variant(flags):
            got = {"disco": mk.persistent_render(disco[0], disco[1], (0, 0), **disco[2]),
                   "box": mk.persistent_render(box[0], box[1], (0, 0), **box_kw)}
            parts = {what: [rk.replay_persistent(table, cam, (0, 0), ct, **kw) for _ in range(2)]
                     for what, (table, cam, kw) in replays.items()}
        rec["forward_bitwise"] = {k: bool(torch.equal(v[0], want[k])) for k, v in got.items()}
        launches = [("k2_disco", "forward", disco[0], disco[1], disco[2]),
                    ("k2_box_chunk", "forward", box[0], box[1], box_kw)]
        launches += [(what, "replay", *case) for what, case in replays.items()]
        for what, kernel, table, cam, kw in launches:
            args = (kernel, table, cam, (0, 0), kw["cfg"], kw["n_cells"], kw["n_items"],
                    kw["ior"], ct)
            simt_launch(lib, *args)
            runs = [simt_launch(lib, *args) for _ in range(3)]
            counters, lanes, _ = runs[0]
            rec[what] = {"ms": sorted(ms for _, _, ms in runs)[1], "segments": counters[0],
                         "iters": counters[1], "lanes": lanes,
                         "occupancy": counters[0] / (counters[1] * lanes),
                         "lane_efficiency": counters[0] / (32 * counters[3])}
            if kernel == "replay":
                (part, st), (again, _) = parts[what]
                ref, ref_st = refs[what]
                worst = max(float((part[sl] - ref[sl]).abs().max())
                            / (1e-4 * float(ref[sl].abs().max()) + 1e-7)
                            for sl in partial_blocks(table.shape[0]).values())
                rec[what].update(spheres=int(table.shape[0]), worst_share_of_tolerance=worst,
                                 bitwise_repeat=bool(torch.equal(part, again)),
                                 segments_equal=int(st["segments"]) == ref_st["segments"])
        emit(rec)


def baseline_library(csrc: str):
    """The kernels built from another checkout's ``csrc`` directory (the
    parent commit's, unpacked with ``git archive``), loaded and declared as
    ``_build.load`` does."""
    real = _build.CSRC_DIR
    _build.CSRC_DIR = _build.Path(os.path.abspath(csrc))
    try:
        return _build.load.__wrapped__(_build.FLAGS)
    finally:
        _build.CSRC_DIR = real


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` text split by function: {label: instructions},
    the label ``roofline.kernel_label``'s (a mangled name carries a hash of
    the source file's path) and each instruction without its address."""
    out, name = {}, None
    for ln in text.splitlines():
        if "Function : " in ln:
            name = roofline.kernel_label(ln.split("Function : ")[1].strip())
            out[name] = []
        elif name and "/*" in ln and ";" in ln:
            out[name].append(ln.split("*/", 1)[1].split(";")[0].strip())
    return {k: "\n".join(v) for k, v in out.items()}


def part_geometry_designs(dev, baseline: str | None):
    """The geometry replay kernel against the baseline build (``--baseline``:
    another checkout's ``csrc``, the parent commit's) in one process, on
    ``part_simt``'s three chunks (a box and a simple chunk with a seeded
    normal cotangent, the geometry path's first chunk with its own) and on
    three chunks of the larger buckets: smallpt (10 spheres, closed), simple
    with every sphere twice (10, open, every swept bounce tied) and the first
    40 spheres of random_spheres.  The replay kernel, the baseline and this
    build each 1 warm-up and the median of 3 launches, in the order replay,
    baseline, this, this, baseline, replay; the baseline's partials against
    this build's (within 1e-4 of each block's largest magnitude + 1e-7; not
    on the tie scene, whose split the baseline lacks), both builds'
    registers and spills.  Then the SASS of every kernel but the geometry
    replay's, baseline against this build: equal text where the tie count's
    ``kAux`` code compiled out."""
    from cpu_path_tracing_tpu_torch.models.scene import Scene
    from cpu_path_tracing_tpu_torch.ops.geometry_replay import geometry_partial_blocks
    from cpu_path_tracing_tpu_torch.ops.kernels import geometry_replay as gk

    libs = {"this": _build.load()}
    ptxas = {"this": render_kernel_ptxas(_build.FLAGS, ("geometry_replay",))}
    if baseline:
        libs["baseline"] = baseline_library(baseline)
        ptxas["baseline"] = render_kernel_ptxas(
            None, ("geometry_replay",), _build.Path(libs["baseline"]._name).with_suffix(".log"))
    emit({"geometry_designs_ptxas": ptxas})
    order = [name for name in ("baseline", "this") if name in libs]
    cfg = tp.RenderConfig(**GEOMETRY_CFG)
    n_items = cfg.spp * GEOMETRY_CHUNK
    ct = torch.from_numpy(np.random.default_rng(11).normal(0, 1, (GEOMETRY_CHUNK, 3))
                          .astype(np.float32)).to(dev)
    chunks = {}
    for name in ("box", "simple"):
        table, cam, kw = packed(name, cfg, dev)
        chunks[name] = (table, cam, ct, kw["ior"])
    table, cam, step_ct = geometry_step_chunk(dev)
    chunks["step"] = (table, cam, step_ct, 2.0)
    simple = tp.get_scene("simple", cfg.width, cfg.height)
    idx = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2, 3, 4])
    twice = Scene(**{f: getattr(simple, f)[idx] for f in ("p0", "radius", "anchor_dir",
                                                          "emission", "albedo", "material")},
                  background=simple.background, camera=simple.camera, ior=simple.ior)
    for what, scene in (("smallpt", tp.get_scene("smallpt", cfg.width, cfg.height)),
                        ("simple_twice", twice),
                        ("random_spheres_40", first_spheres("random_spheres", 40, cfg))):
        chunks[what] = (mk.pack_scene(scene).to(dev), mk.pack_camera(scene).to(dev), ct,
                        scene.ior)

    def rows_of(lib, table, cam, cot, ior):
        """The partials (float64 sum of the rows) and counters of one launch."""
        with kernel_variant_lib(lib):
            part, st = gk.geometry_replay(table, cam, (0, 0), cot, cfg=cfg,
                                          n_cells=GEOMETRY_CHUNK, n_items=n_items, ior=ior)
        return part, {k: int(v) if torch.is_tensor(v) else v for k, v in st.items()}

    for what, (table, cam, cot, ior) in chunks.items():
        args = (table, cam, (0, 0), cfg, GEOMETRY_CHUNK, n_items, ior, cot)
        times = {name: [] for name in ("replay", *order)}
        for sweep in (["replay", *order], [*reversed(order), "replay"]):
            for name in sweep:
                lib, kernel = ((libs["this"], "replay") if name == "replay"
                               else (libs[name], "geometry"))
                simt_launch(lib, kernel, *args)
                times[name] += [simt_launch(lib, kernel, *args)[2] for _ in range(3)]
        ref, ref_st = rows_of(libs["this"], table, cam, cot, ior)
        again, _ = rows_of(libs["this"], table, cam, cot, ior)
        rec = {"geometry_designs": what, "spheres": int(table.shape[0]), "n_items": n_items,
               "counts": ref_st, "bitwise_repeat": bool(torch.equal(ref, again)),
               "smi": smi(), "builds": {}}
        for name in ("replay", *order):
            ts = sorted(times[name])
            rec["builds"][name] = {"median_ms": ts[len(ts) // 2], "runs_ms": times[name]}
        if "baseline" in libs and what != "simple_twice":
            part, st = rows_of(libs["baseline"], table, cam, cot, ior)
            worst = max(float((part[sl] - ref[sl]).abs().max())
                        / (1e-4 * float(ref[sl].abs().max()) + 1e-7)
                        for sl in geometry_partial_blocks(table.shape[0]).values())
            rec["builds"]["baseline"].update(
                worst_share_of_tolerance=worst,
                counts_equal={k: st[k] == ref_st[k] for k in ("segments", "missed",
                                                               "sweep_bounces")})
        emit(rec)
    if baseline:
        tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
        new = sass_functions(_build.sass())
        old = sass_functions(subprocess.run([tool, "-sass", libs["baseline"]._name],
                                            capture_output=True, text=True, check=True).stdout)
        same = {k: new.get(k) == v for k, v in old.items() if "geometry_replay" not in k}
        emit({"sass_equal_to_baseline": same, "all_equal": all(same.values())})


def part_scenes(dev):
    for name in tp.scene_names():
        if name == "disco_sphere":  # the alias of box_mirror
            continue
        table, cam, kw = packed(name, MAIN, dev)
        times, (_, st) = event_times(lambda: mk.persistent_render(table, cam, (0, 0), **kw))
        ms = sorted(times)[len(times) // 2]
        seg, iters, lanes = int(st["segments"]), int(st["iters"]), st["lanes"]
        emit({"scene": name, "spheres": int(table.shape[0]), "ms": ms, "runs_ms": times,
              "segments": seg, "segments_per_item": seg / kw["n_items"],
              "mrays_per_s": seg / ms / 1e3, "iters": iters, "lanes": lanes,
              "occupancy": seg / (iters * lanes)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("build", "fmad", "profile", "scenes", "train", "step",
                                       "probe", "stream", "simt", "designs", "geometry",
                                       "geometry_designs", "geometry_step", "sharded",
                                       "multicard", "threads", "all"),
                    default="all")
    ap.add_argument("--baseline", default=None,
                    help="--part geometry_designs: another checkout's csrc directory to time "
                         "beside this one (the parent commit's, from git archive)")
    ap.add_argument("--variants", default=None,
                    help="--part designs: comma-separated names of DESIGNS (default: all)")
    ap.add_argument("--out", default=None,
                    help="also append every JSON line to this file (its directory is made)")
    args = ap.parse_args()
    if args.out:
        global OUT
        OUT = args.out
        os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print("smi", smi(), flush=True)
    for part, run in (("build", part_build), ("fmad", part_fmad), ("profile", part_profile),
                      ("scenes", part_scenes), ("train", part_train), ("step", part_step),
                      ("probe", part_probe), ("stream", part_stream)):
        if args.part in (part, "all"):
            run(dev)
    if args.part == "simt":
        part_simt(dev)
    if args.part == "designs":
        part_designs(dev, args.variants.split(",") if args.variants else None)
    if args.part == "geometry":
        part_geometry(dev)
    if args.part == "geometry_designs":
        part_geometry_designs(dev, args.baseline)
    if args.part == "geometry_step":
        part_geometry_step(dev)
    if args.part == "sharded":
        part_sharded(dev)
    if args.part == "multicard":
        part_multicard(dev)
    if args.part == "threads":
        part_threads(dev)
    print("smi", smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
