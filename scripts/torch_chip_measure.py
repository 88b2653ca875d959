#!/usr/bin/env python3
"""Measurements of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 scripts/torch_chip_measure.py
        [--part build|fmad|profile|scenes|train|step|probe|stream|all]

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

Imports nothing of JAX.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import ctypes
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


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


@contextlib.contextmanager
def kernel_variant(flags):
    """Make the wrapper launch the library built with ``flags``."""
    lib = _build.load(flags)
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
                                       "probe", "stream", "all"), default="all")
    args = ap.parse_args()
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
    print("smi", smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
