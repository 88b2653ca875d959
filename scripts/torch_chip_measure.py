#!/usr/bin/env python3
"""Measurements of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 scripts/torch_chip_measure.py [--part build|fmad|profile|scenes|train|step|probe|all]

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
  ``ops/wavefront.drive_items`` with the per-step kernel): CUDA-event ms
  (1 warm-up, 3 runs) with the loop's sync every 16 steps and every 64, in
  the order 16, 64, 16, 64; the pool widths 2^17, 2^19 and 2^21 (ms,
  iterations, occupancy); a cProfile of one render (host time by function);
  then ``torch.profiler`` over 3 renders as in profile.
- probe: the machine-constant probe (``scripts/torch_perf_probe.py``) three
  times in one process: each run's line, then each constant's least, median
  and greatest value and its spread, (greatest - least) / median; then the
  fma chain at 2,048, 8,192 and 32,768 iterations (what a launch costs
  beside its loop).

Imports nothing of JAX.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
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


def part_step(dev):
    from cpu_path_tracing_tpu_torch.ops import wavefront

    scene = tp.get_scene("box_mirror", MAIN.width, MAIN.height).to(dev)
    ids = torch.arange(MAIN.num_cells, device=dev)

    def call(lanes=None):
        return wavefront.drive_items(mk.megakernel_step, scene, MAIN, ids, 0, MAIN.spp, lanes)

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
                                       "probe", "all"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print("smi", smi(), flush=True)
    for part, run in (("build", part_build), ("fmad", part_fmad), ("profile", part_profile),
                      ("scenes", part_scenes), ("train", part_train), ("step", part_step),
                      ("probe", part_probe)):
        if args.part in (part, "all"):
            run(dev)
    print("smi", smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
