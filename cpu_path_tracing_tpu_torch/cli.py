"""Command-line interface: the ``render``, ``invert`` and ``bench`` subcommands.

Counterpart of ``cpu_path_tracing_tpu/cli.py``:

    python -m cpu_path_tracing_tpu_torch.cli render --scene box_mirror \\
        --width 1024 --height 768 --total-spp 32 -o disco.png
    python -m cpu_path_tracing_tpu_torch.cli render --total-spp 32 \\
        --tile-cells 524288 --max-retries 2 --checkpoint tiles.npz
    python -m cpu_path_tracing_tpu_torch.cli render --total-spp 32 \\
        --checkpoint progress.npz --flush-every 2 --preview preview.png
    python -m cpu_path_tracing_tpu_torch.cli invert --scene box \\
        --width 400 --height 400 --spp 16 --steps 100 --checkpoint inv.npz
    python -m cpu_path_tracing_tpu_torch.cli bench --scene box_mirror --total-spp 32
    python -m cpu_path_tracing_tpu_torch.cli bench --suite --suite-out suite.md
    python -m cpu_path_tracing_tpu_torch.cli render --scene box --width 64 \\
        --height 48 --spp 2 --device cpu -o box.png
    python -m cpu_path_tracing_tpu_torch.cli render --total-spp 32 --mesh 4x2
    python -m cpu_path_tracing_tpu_torch.cli render --coordinator HOST0:12345 \\
        --num-processes 2 --process-id $RANK --shard-dir shards/
    python -m cpu_path_tracing_tpu_torch.cli invert --scene box --mesh 2x2
    python -m cpu_path_tracing_tpu_torch.cli bench --scaling

Every subcommand runs on the card (``--device cuda``, the default) and
fails before doing any work when there is none; ``--device cpu`` asks for
the CPU.  ``--scene-file`` loads a JSON scene (``models/io.py``) in place of
``--scene``.  ``--debug-nans`` runs the command inside
``utils/debug.debug_context``: a NaN in a render's sums or an inverse step's
loss or gradients raises ``FloatingPointError``, on the same route.
``--profile-dir DIR`` captures a ``torch.profiler`` trace of the command
there (``utils/profiling.maybe_trace``), with the port's ``pt.*`` spans
(``pt.render_image``, ``pt.step``, ``pt.grad.*``, ``pt.adam``, the kernel
wrappers' ``pt.k2``, ``pt.k3``, ``pt.k7``, ``pt.progressive.*``) beside the
card's rows.

``render`` renders the image in one pass (``render.render_image``); as
tiles, retried on failure and resumable from ``--checkpoint``, with
``--tile-cells`` (``orchestrator.render_tiled``; ``--inject-fault`` fails
chosen tiles); or progressively, ``--flush-every`` samples a cell a batch,
checkpointed and resumable, with a preview after each batch, with
``--checkpoint`` or ``--preview`` (``utils/checkpoint.render_progressive``).

``--mesh TxS`` renders (``render``) or takes the inverse step (``invert``)
over a T-tile by S-sample-shard mesh in one process
(``parallel/render.py``, ``grad.make_sharded_accum_train_step``), its
entries the visible devices of ``--device``'s kind in turn, repeated when
the mesh has more entries than there are devices (``_mesh``).
``--num-processes N`` with ``--coordinator HOST:PORT`` and
``--process-id`` renders over N processes on ``torch.distributed``
(``parallel/distributed.py``, ``_render_multihost``): by default the ranks'
sums are all-gathered and rank 0 writes the image; with ``--shard-dir``
each rank writes its own cells there and rank 0 assembles them, waiting at
most ``--shard-timeout`` seconds for them before it re-renders the cells of
a rank that never wrote (``--inject-shard-loss P`` makes rank P exit with
code 3 before it writes).  ``bench --scaling`` renders one image on meshes
of 1, 2, 4, ... of the visible devices and prints each one's speed-up.

``--integrator`` picks the route (``render.resolve_integrator``): 'pallas'
the CUDA kernels, 'wavefront' the plain wavefront loop, 'auto' the kernels
for a float32, uniform-jitter scene on the card.  ``bench`` times the
per-step path, as the JAX ``cmd_bench`` does: with 'auto' on the card the
per-step kernel, elsewhere ``render_wavefront``; one warm-up run, then the
best of ``--repeats`` (CUDA-event time on the card), and one
``RenderReport`` JSON line on stdout.  ``bench --suite`` runs
``BENCH_MATRIX`` through ``render.render_cells_range`` (the whole-render
kernel on the card) and the production inverse step (the best of
``--repeats`` windows of 3 steps), one JSON line a row,
and a markdown table naming the card and its power limit
(``--suite-out``); ``--suite-scale`` divides each row's spp.

``--total-spp N`` keeps the reference's meaning (N / subpixels^2 samples
per subpixel cell, ``src/main.cpp:203-206``).  ``invert`` renders the
scene as the target, perturbs the ``--fields`` (any of ``grad.OPTIMIZABLE``:
p0, radius, albedo, emission, camera, background) with seeded normal noise
and fits them back with Adam, printing one JSON line per reported step;
with ``--checkpoint`` it saves the params and Adam's state every
``--save-every`` steps and resumes from them (``utils/checkpoint.py``).
Its backward takes one of ``grad.backward_route``'s three routes: the
replay for albedo, emission and background alone; on the card, for p0,
radius or the camera in a float32 scene of at most 40 spheres with uniform
jitter, the geometry replay kernel (and the replay kernel for the other
fields); else the scan VJP recomputed ``--sample-chunk`` samples at a time,
with live-ray compaction unless ``--no-compact-backward``.
``--no-replay-backward`` sends every field set to the scan VJP
(``grad.make_diff_render_span``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import RenderConfig, get_scene, scene_names, write_png, write_ppm
from .render import render_image
from .utils.metrics import ProgressLogger, RenderReport, Timer, device_label
from .utils.profiling import maybe_trace

def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="box_mirror", choices=scene_names())
    p.add_argument("--scene-file", default=None,
                   help="load the scene from a JSON file instead of --scene (models/io.py)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    sp = p.add_mutually_exclusive_group()
    sp.add_argument("--spp", type=int, default=None, help="samples per subpixel cell")
    sp.add_argument("--total-spp", type=int, default=None,
                    help="total spp as in the reference CLI (divided by subpixels^2)")
    p.add_argument("--subpixels", type=int, default=2, help="subpixels per pixel axis")
    p.add_argument("--max-depth", type=int, default=100)
    p.add_argument("--rr-depth", type=int, default=4,
                   help="Russian roulette when depth > this")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default; fails without a card) or cpu")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace here, with the port's pt.* spans "
                   "(pt.render_image, pt.step, pt.grad.*, pt.adam, pt.k2, pt.k3, pt.k7, "
                   "pt.progressive.*) beside the card's rows")
    p.add_argument("--debug-nans", action="store_true",
                   help="NaN guard: raise FloatingPointError at a NaN in a render's sums or "
                        "an inverse step's loss or gradients (utils/debug.py)")
    p.add_argument("--integrator", choices=("auto", "wavefront", "pallas"), default="auto")
    p.add_argument("--jitter", choices=("uniform", "tent"), default="uniform",
                   help="subpixel filter: uniform (reference binary) or tent (sandbox "
                        "smallpt; the plain paths only)")
    p.add_argument("--lanes", type=int, default=None,
                   help="lane-pool width of the per-step paths (default 1<<19)")
    p.add_argument("--mesh", default=None, help="TILESxSAMPLES device mesh, e.g. 4x2")
    # The process group of parallel/distributed.py; one process a rank.
    p.add_argument("--coordinator", default=None, help="rank 0's address HOST:PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--shard-dir", default=None,
                   help="no-collective mode: each rank writes its cells here, rank 0 "
                        "assembles them")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cpu_path_tracing_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="render a scene to PNG or PPM")
    _add_common(p)
    p.add_argument("-o", "--out", default="image.png", help=".png or .ppm")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path (.npz): the progressive sums, or with --tile-cells "
                        "the done tiles; resumes if present")
    p.add_argument("--flush-every", type=int, default=0,
                   help="samples per cell per checkpointed batch (0: all at once)")
    p.add_argument("--preview", default=None,
                   help="write the partial image here after every batch (on the native "
                        "writer thread)")
    p.add_argument("--tile-cells", type=int, default=0,
                   help="render as independent retried tiles of this many cells "
                        "(0: one pass)")
    p.add_argument("--max-retries", type=int, default=2, help="retries per failed tile")
    p.add_argument("--inject-fault", default=None, metavar="TILE[:TIMES],...",
                   help="fault injection: fail these tiles on their first TIMES attempts")
    p.add_argument("--inject-shard-loss", type=int, default=None, metavar="PROC",
                   help="fault injection (--shard-dir): rank PROC exits with code 3 after "
                        "rendering, before it writes its shard")
    p.add_argument("--shard-timeout", type=float, default=300.0,
                   help="seconds rank 0 waits for the other ranks' shard files before it "
                        "re-renders the missing cells itself")
    p = sub.add_parser("invert", help="inverse rendering (recover scene params)")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--fields", default="albedo,emission")
    p.add_argument("--perturb", type=float, default=0.05)
    p.add_argument("--cell-chunk", type=int, default=1 << 17,
                   help="cells per gradient-accumulation chunk")
    p.add_argument("--sample-chunk", type=int, default=1,
                   help="samples per backward recompute (bounds the scan VJP's memory)")
    p.add_argument("--no-compact-backward", action="store_true",
                   help="disable live-ray compaction in the scan VJP")
    p.add_argument("--no-replay-backward", action="store_true",
                   help="use the scan VJP for every field set (no replay kernel, no "
                        "geometry replay kernel)")
    p.add_argument("--checkpoint", default=None,
                   help="params and optimizer-state checkpoint (.npz); resumes if present")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint every N steps (default: steps/10)")
    p = sub.add_parser("bench", help="time the per-step wavefront render, or the suite")
    _add_common(p)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--suite", action="store_true",
                   help="run the BENCH_MATRIX rows and the inverse step")
    p.add_argument("--suite-scale", type=int, default=1,
                   help="divide each row's spp by this (for CPU smoke runs)")
    p.add_argument("--suite-out", default=None, help="write the suite's markdown table here")
    p.add_argument("--scaling", action="store_true",
                   help="the render on meshes of 1, 2, 4, ... of the visible devices")
    p.add_argument("--ring", type=int, default=None,
                   help="not ported: the port has no result ring")
    return ap


def _config(args) -> RenderConfig:
    spp = args.spp
    if spp is None:
        total = args.total_spp if args.total_spp is not None else 4
        spp = max(1, total // (args.subpixels * args.subpixels))
    lanes = {} if args.lanes is None else {"wavefront_lanes": args.lanes}
    return RenderConfig(width=args.width, height=args.height, spp=spp,
                        num_subpixels=args.subpixels, max_depth=args.max_depth,
                        rr_depth=args.rr_depth, seed=args.seed, integrator=args.integrator,
                        jitter=args.jitter, **lanes)


def _scene(args, cfg: RenderConfig):
    """The scene asked for (``--scene-file`` or ``--scene``), on ``args.device``."""
    if args.scene_file:
        from .models.io import load_scene

        scene = load_scene(args.scene_file, cfg.width, cfg.height)
    else:
        scene = get_scene(args.scene, cfg.width, cfg.height)
    return scene.to(args.device)


def _device(args) -> torch.device:
    """The device asked for; a CUDA device that is not there is an error,
    never a silent move to the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return device


def _mesh_shape(args):
    """``--mesh TxS`` as (T, S), or None."""
    if not args.mesh:
        return None
    try:
        n_tiles, n_samples = (int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {args.mesh!r}: expected TILESxSAMPLES, e.g. 4x2") from None
    return n_tiles, n_samples


def _visible_devices(device: torch.device) -> list:
    """The distinct devices of ``device``'s kind: every visible card for
    ``cuda`` without an index, else ``device`` alone."""
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _mesh(args):
    """The ``--mesh`` of ``args.device``'s kind: the visible devices in
    turn, each repeated when the mesh has more entries than there are
    devices (a 2x2 mesh on one card is four entries of it)."""
    from .parallel.mesh import make_mesh

    n_tiles, n_samples = _mesh_shape(args)
    devices = _visible_devices(args.device)
    return make_mesh(n_tiles, n_samples,
                     [devices[i % len(devices)] for i in range(n_tiles * n_samples)])


def cmd_render(args) -> int:
    if args.num_processes:
        return _render_multihost(args)
    cfg = _config(args)
    scene = _scene(args, cfg)
    with Timer() as t:
        if args.mesh:
            from .parallel.render import render_image_sharded

            img = render_image_sharded(scene, cfg, _mesh(args))
        elif args.tile_cells:
            from .orchestrator import FaultInjector, render_tiled

            injector = FaultInjector.parse(args.inject_fault) if args.inject_fault else None
            img = render_tiled(scene, cfg, tile_cells=args.tile_cells,
                               checkpoint_path=args.checkpoint, max_retries=args.max_retries,
                               fault_injector=injector, progress=ProgressLogger(cfg.total_spp))
        elif args.checkpoint or args.preview:
            from .utils.checkpoint import render_progressive

            img = render_progressive(scene, cfg, args.checkpoint, args.flush_every,
                                     progress=ProgressLogger(cfg.total_spp),
                                     preview_path=args.preview)
        else:
            img = render_image(scene, cfg)
        img = img.cpu()  # the copy waits for the device
    (write_ppm if args.out.endswith(".ppm") else write_png)(args.out, img)
    print(f"{args.scene_file or args.scene} {cfg.width}x{cfg.height} @ {cfg.total_spp} total "
          f"spp on {scene.device} -> {args.out} in {t.seconds:.2f}s", file=sys.stderr)
    return 0


def _exit_now(code: int) -> None:
    """Leave at once with ``code``: after a lost rank, past the shutdown of
    a process group that still counts the dead rank."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _render_multihost(args) -> int:
    """Render over ``--num-processes`` ranks (``parallel/distributed.py``).

    Replicated mode (the default): the ranks' sums are all-gathered and rank
    0 writes the image.  Shard mode (``--shard-dir``): no collective; each
    rank writes its own cells and rank 0, after waiting for the files,
    assembles them and re-renders those of a rank that never wrote."""
    import torch.distributed as dist

    from .parallel.distributed import (
        assemble_shards, global_mesh, init_distributed, rank_device, render_fingerprint,
        render_image_multihost, render_shard_multihost, signal_lost_hosts, wait_all_or_lost,
        wait_for_shards, write_shards)

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    args.device = rank_device(args.device)
    cfg = _config(args)
    scene = _scene(args, cfg)
    mesh = global_mesh(n_samples=_mesh_shape(args)[1] if args.mesh else 1)
    pid, world = dist.get_rank(), dist.get_world_size()
    for flag in ("tile_cells", "checkpoint", "preview"):
        if getattr(args, flag, None):
            print(f"WARNING: --{flag.replace('_', '-')} is a single-process feature and is "
                  "ignored under --num-processes", file=sys.stderr)
    lost_hosts = False
    with Timer() as t:
        if args.shard_dir:
            fp = render_fingerprint(scene, cfg)
            shards = render_shard_multihost(scene, cfg, mesh)
            if args.inject_shard_loss is not None and pid == args.inject_shard_loss:
                # This rank dies after rendering, before its shard is written.
                print(f"inject-shard-loss: process {pid} exiting", file=sys.stderr)
                _exit_now(3)
            write_shards(args.shard_dir, shards, cfg, pid, fingerprint=fp)
            if pid == 0:
                names = wait_for_shards(args.shard_dir, world, timeout=args.shard_timeout,
                                        fingerprint=fp)
                lost_hosts = len(names) < world
                if lost_hosts:
                    # Published before the recovery render, so that the other
                    # survivors leave at once.
                    signal_lost_hosts(args.shard_dir)
                img = assemble_shards(args.shard_dir, cfg, scene=scene, fingerprint=fp).cpu()
            else:
                # Past --shard-timeout by a margin for rank 0's own detection.
                outcome = wait_all_or_lost(args.shard_dir, world,
                                           timeout=args.shard_timeout + 30.0, fingerprint=fp)
                if outcome == "lost":
                    print(f"process {pid}: a lost rank was signalled; shard written, exiting",
                          file=sys.stderr)
                    _exit_now(0)
                if outcome == "timeout":
                    print(f"process {pid}: no completion or loss signal within the timeout "
                          "(rank 0 may have died)", file=sys.stderr)
                    return 1
                img = None
        else:
            img = render_image_multihost(scene, cfg, mesh).cpu()
    if pid == 0:
        (write_ppm if args.out.endswith(".ppm") else write_png)(args.out, img)
        print(f"[{world} processes, rank 0 on {scene.device}] {args.scene_file or args.scene} "
              f"{cfg.width}x{cfg.height} @ {cfg.total_spp} total spp -> {args.out} in "
              f"{t.seconds:.2f}s", file=sys.stderr)
        if lost_hosts:
            _exit_now(0)
    dist.destroy_process_group()
    return 0


def perturbed_params(true_params: dict, seed: int, perturb: float) -> dict:
    """``true_params`` plus seeded normal noise, drawn leaf by leaf from one
    NumPy stream in the JAX pytree's order (``grad.flatten_params``: keys
    sorted, a camera's eight fields in ``CameraConfig`` order), the order in
    which the JAX CLI's ``jax.tree.map`` visits the params.  So the start
    equals the JAX CLI's for the same seed and does not depend on the order
    of ``--fields``."""
    from .grad import flatten_params, unflatten_params

    rng = np.random.default_rng(seed)
    names, leaves = flatten_params(true_params)
    out = unflatten_params(names, [
        v + torch.as_tensor(rng.normal(0, perturb, tuple(v.shape)), dtype=v.dtype, device=v.device)
        for v in leaves])
    return {k: out[k] for k in true_params}


def mean_abs_errors(params: dict, true_params: dict) -> dict:
    """Mean |params - true_params| per field; ``camera`` a dict of its eight
    fields (the JAX CLI's ``jax.tree.map`` over the camera gives a
    dataclass, which its JSON line cannot print)."""
    from .grad import flatten_params

    errs = {}
    for name, a, b in zip(*flatten_params(params), flatten_params(true_params)[1]):
        field, _, leaf = name.partition(".")
        err = float((a - b).abs().mean())
        if leaf:
            errs.setdefault(field, {})[leaf] = err
        else:
            errs[field] = err
    return errs


def cmd_invert(args) -> int:
    from .grad import make_accum_train_step, render_target, split_params
    from .utils.checkpoint import InvertState, invert_fingerprint, load_or_init_invert

    cfg = _config(args)
    fields = tuple(args.fields.split(","))
    scene = _scene(args, cfg)
    true_params = split_params(scene, fields)  # raises for a field outside OPTIMIZABLE
    with Timer() as t:
        target = render_target(scene, cfg, args.cell_chunk)
        target.sum().item()  # waits for the device
    print(f"target rendered in {t.seconds:.2f}s", file=sys.stderr)

    params = perturbed_params(true_params, args.seed, args.perturb)
    fp = invert_fingerprint(scene, cfg, fields, args.lr, cell_chunk=args.cell_chunk,
                            sample_chunk=args.sample_chunk, mesh_shape=_mesh_shape(args))
    state = load_or_init_invert(args.checkpoint, fp, params)
    kw = dict(cell_chunk=args.cell_chunk, sample_chunk=args.sample_chunk,
              compact=not args.no_compact_backward, replay=not args.no_replay_backward)
    if args.mesh:
        from .grad import make_sharded_accum_train_step

        step_fn = make_sharded_accum_train_step(_mesh(args), scene, cfg, args.lr, **kw)
    else:
        step_fn = make_accum_train_step(scene, cfg, args.lr, **kw)
    if state.step:
        print(f"resumed from {args.checkpoint} at step {state.step}", file=sys.stderr)
        step_fn.load_state_dict({"params": state.params, "optimizer": state.opt_state})
    params = state.params
    save_every = args.save_every or max(1, args.steps // 10)
    t0 = time.perf_counter()
    for step in range(state.step, args.steps):
        params, loss = step_fn(params, target)
        if args.checkpoint and ((step + 1) % save_every == 0 or step == args.steps - 1):
            sd = step_fn.state_dict()
            InvertState(sd["params"], sd["optimizer"], step + 1, fp).save(args.checkpoint)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            loss = float(loss)  # waits for the device
            sps = (step + 1 - state.step) / (time.perf_counter() - t0)
            rec = {"step": step, "loss": loss, "steps_per_s": round(sps, 4),
                   "mean_abs_err": mean_abs_errors(params, true_params)}
            # The compacted backward's monitor (JAX cli.py:343-355): report,
            # never hide, live rays a capacity would truncate at these params.
            if hasattr(step_fn, "drop_check"):
                dropped = step_fn.drop_check(params)
                if dropped:
                    rec["backward_dropped_lanes"] = dropped
                    print(f"WARNING: compacted backward truncated {dropped} live lanes at step "
                          f"{step}; gradients carry a depth-truncation bias on those lanes: "
                          "pass --no-compact-backward", file=sys.stderr)
            print(json.dumps(rec), flush=True)
    return 0


def _run_seconds(fn, repeats: int, device) -> list:
    """Seconds of each of ``repeats`` runs of ``fn()``, after the caller's
    warm-up: CUDA events around each run on the card, the host clock
    elsewhere.  The callers report the best."""
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return times


# The BASELINE.md benchmark matrix (JAX cli.py:364-372: resolutions and spp
# from BASELINE.json's `configs`), plus the 512-sphere stress scene.
BENCH_MATRIX = (
    # (scene, width, height, total_spp)
    ("simple", 640, 480, 16),
    ("box", 400, 400, 64),
    ("depth_of_field", 800, 600, 256),
    ("disco_sphere", 1024, 768, 1024),
    ("random_spheres", 640, 480, 64),
    ("random_spheres_512", 640, 480, 64),
)


def _bench_one(scene_name, width, height, total_spp, *, device, integrator="auto", lanes=None,
               repeats=3):
    """One suite row: the whole image through ``render_cells_range`` in
    ``sample_chunk_for`` launches (the whole-render kernel on the card),
    timed after a warm-up whose stats are read once, untimed.  Returns the
    ``RenderReport`` and the row's forward-kernel launches a render, route
    and lane efficiency (segments over 32 lanes times the bounce phases
    the warps ran; None off the kernel).  The path-length histogram comes
    from an untimed one-sample ``render_wavefront``, as the JAX suite takes
    it from its XLA wavefront."""
    from .ops.kernels.megakernel import persistent_render
    from .ops.wavefront import render_wavefront
    from .render import render_cells_range, resolve_integrator, sample_chunk_for

    spp = max(1, total_spp // 4)
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=100,
                       integrator=integrator, **({} if lanes is None else
                                                 {"wavefront_lanes": lanes}))
    scene = get_scene(scene_name, width, height).to(device)
    ids = range(cfg.num_cells)
    chunk = sample_chunk_for(spp, cfg.num_cells)

    def run():
        return [render_cells_range(scene, cfg, ids, start, chunk, with_stats=True)[1]
                for start in range(0, spp, chunk)]

    launches0 = persistent_render.launches
    stats = run()
    launches = persistent_render.launches - launches0
    segments = sum(int(st["segments"]) for st in stats)
    phases = sum(int(st.get("phases", 0)) for st in stats)
    best = min(_run_seconds(run, repeats, device))
    _, hstats = render_wavefront(scene, cfg, ids, 0, 1, with_stats=True, depth_hist=True)
    hist = [int(v) for v in hstats["depth_hist"].tolist()]
    rep = RenderReport(scene=scene_name, width=width, height=height, total_spp=cfg.total_spp,
                       seconds=best, segments=segments, camera_rays=cfg.num_cells * cfg.spp,
                       iters=sum(int(st["iters"]) for st in stats),
                       lanes=int(stats[-1]["lanes"]), depth_hist=hist,
                       device=device_label(device))
    extra = {"route": resolve_integrator(scene, cfg), "k2_launches": launches,
             "lane_efficiency": segments / (32 * phases) if phases else None}
    return rep, extra


def _bench_invert(*, device, repeats):
    """Inverse-rendering throughput: optimizer steps/s on box at the
    BASELINE.json inverse config (400x400 @ 64 total spp, max_depth 100,
    albedo and emission from +0.02, Adam lr 1e-2, 131,072-cell chunks):
    the forward kernel and the replay kernel on the card.  Off the card the
    config is JAX's shrunk one (64x64 @ 8 total spp, max_depth 12).  One
    warm-up step, then the best of ``repeats`` windows of 3 steps (5 off the
    card, as JAX's), each ended by a synchronize; every window's rate is
    kept beside the best."""
    from .grad import make_accum_train_step, render_target, split_params
    from .ops.kernels.megakernel import persistent_render
    from .ops.kernels.replay import replay_persistent

    if device.type == "cuda":
        cfg = RenderConfig(width=400, height=400, spp=16, max_depth=100)
        cell_chunk, steps = 1 << 17, 3
    else:
        cfg = RenderConfig(width=64, height=64, spp=2, max_depth=12)
        cell_chunk, steps = 1 << 14, 5
    scene = get_scene("box", cfg.width, cfg.height).to(device)
    target = render_target(scene, cfg, cell_chunk)
    params = {k: v + 0.02 for k, v in split_params(scene, ("albedo", "emission")).items()}
    step_fn = make_accum_train_step(scene, cfg, 1e-2, cell_chunk=cell_chunk, sample_chunk=1)
    k2, k3 = persistent_render.launches, replay_persistent.launches
    params, loss0 = step_fn(params, target)  # warm-up
    loss0 = float(loss0)
    k2, k3 = persistent_render.launches - k2, replay_persistent.launches - k3
    holder = {"params": params}

    def run():
        for _ in range(steps):
            holder["params"], holder["loss"] = step_fn(holder["params"], target)

    rates = [steps / s for s in _run_seconds(run, repeats, device)]
    return {
        "scene": (f"box (inverse rendering, {cfg.width}x{cfg.height}@{cfg.total_spp} "
                  f"total spp, max_depth {cfg.max_depth}, albedo/emission)"),
        "steps_per_s": round(max(rates), 4),
        "steps_per_s_windows": [round(r, 4) for r in rates], "steps_per_window": steps,
        "loss_start": loss0,
        "loss_end": float(holder["loss"]),
        "k2_launches_per_step": k2, "k3_launches_per_step": k3,
        "device": device_label(device),
    }


def cmd_bench_suite(args) -> int:
    from .utils.metrics import MetricsSink

    sink = MetricsSink(echo=True)  # one structured record a row on stdout
    rows = []
    for scene_name, w, h, tspp in BENCH_MATRIX:
        tspp = max(4, tspp // args.suite_scale)
        rep, extra = _bench_one(scene_name, w, h, tspp, device=args.device,
                                integrator=args.integrator, lanes=args.lanes,
                                repeats=args.repeats)
        rows.append((rep, extra))
        sink.log(**json.loads(rep.to_json()), **extra)
        print(rep.summary(), file=sys.stderr)
    inv = _bench_invert(device=args.device, repeats=args.repeats)
    sink.log(**inv)

    lines = [
        f"# Benchmark suite — {device_label(args.device)}, integrator={args.integrator}",
        "",
        "| scene | resolution | total spp | route | K2 launches | wall s | Mrays/s | avg depth "
        "| occupancy | lane efficiency | path-len p50/p90/p99 |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r, extra in rows:
        pct = r.depth_percentiles() or {}
        eff = extra["lane_efficiency"]
        lines.append(
            f"| {r.scene} | {r.width}x{r.height} | {r.total_spp} | {extra['route']} | "
            f"{extra['k2_launches']} | {r.seconds:.4f} | {r.mrays_per_s:.1f} | "
            f"{r.avg_depth:.2f} | {100 * r.occupancy:.1f}% | "
            f"{'-' if eff is None else f'{100 * eff:.1f}%'} | "
            f"{pct.get('p50', '-')}/{pct.get('p90', '-')}/{pct.get('p99', '-')} |")
    lines += [
        "",
        f"Inverse rendering ({inv['scene']}): {inv['steps_per_s']} steps/s (loss "
        f"{inv['loss_start']:.3g} -> {inv['loss_end']:.3g}; {inv['k2_launches_per_step']} "
        f"forward and {inv['k3_launches_per_step']} replay kernel launches a step).",
    ]
    report = "\n".join(lines) + "\n"
    if args.suite_out:
        with open(args.suite_out, "w") as fh:
            fh.write(report)
    print(report, file=sys.stderr)
    return 0


def _sync_all(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def cmd_bench_scaling(args) -> int:
    """Strong scaling (JAX ``cmd_bench_scaling``): the same image rendered
    on tiles-only meshes of 1, 2, 4, ... distinct visible devices, one JSON
    line a mesh (host seconds of the best of ``--repeats`` after a warm-up,
    each ended by a synchronize of every card; camera rays per second, not
    path segments; speed-up and efficiency against one device), and a
    markdown table (``--suite-out``).  On the CPU the table is titled a
    plumbing gate: one device, no scaling to measure."""
    from .parallel.mesh import make_mesh
    from .parallel.render import render_cells_sharded

    devices = _visible_devices(args.device)
    counts = [c for c in (1, 2, 4, 8, 16, 32, 64) if c <= len(devices)]
    cfg = _config(args)
    scene = _scene(args, cfg)
    rows = []
    for n in counts:
        mesh = make_mesh(n, 1, devices[:n])

        def run():
            render_cells_sharded(scene, cfg, mesh)
            _sync_all(devices[:n])

        run()  # warm-up
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        rows.append((n, best))
        t1 = rows[0][1]
        print(json.dumps({"devices": n, "seconds": best,
                          "camera_mrays_per_s": cfg.num_cells * cfg.spp / best / 1e6,
                          "speedup": t1 / best, "efficiency_vs_linear": t1 / (n * best),
                          "device": device_label(devices[0])}), flush=True)
    gate = devices[0].type == "cpu"
    lines = [
        f"# {'Mesh-scaling PLUMBING GATE' if gate else 'Strong scaling'} — {args.scene} "
        f"{cfg.width}x{cfg.height}@{cfg.total_spp} total spp on {device_label(devices[0])}",
        "",
        "Fixed workload, tiles-axis mesh over 1..N distinct devices.  Rates are camera",
        "rays/s (cells x spp / wall), not path segments/s: relative efficiency only.",
        *(["", "CAVEAT: one CPU device; this run checks the sharded path, it measures no",
           "scaling."] if gate else []),
        "",
        "| devices | wall s | speedup | efficiency vs linear |",
        "|---|---|---|---|",
    ]
    t1 = rows[0][1]
    for n, dt in rows:
        lines.append(f"| {n} | {dt:.4f} | {t1 / dt:.2f}x | {100 * t1 / (n * dt):.1f}% |")
    report = "\n".join(lines) + "\n"
    if args.suite_out:
        with open(args.suite_out, "w") as fh:
            fh.write(report)
    print(report, file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    if args.ring is not None:
        raise SystemExit("bench --ring is not ported: the port has no result ring")
    if args.scaling:
        return cmd_bench_scaling(args)
    if args.suite:
        return cmd_bench_suite(args)
    from .ops.wavefront import render_wavefront, render_wavefront_per_step
    from .render import resolve_integrator

    cfg = _config(args)
    scene = _scene(args, cfg)
    render_span = (render_wavefront_per_step if resolve_integrator(scene, cfg) == "pallas"
                   else render_wavefront)
    ids = range(cfg.num_cells)

    def run():
        return render_span(scene, cfg, ids, 0, cfg.spp, with_stats=True)

    _, stats = run()  # warm-up; the stats are deterministic and read once, untimed
    best = min(_run_seconds(run, args.repeats, scene.device))
    rep = RenderReport(
        scene=args.scene, width=cfg.width, height=cfg.height, total_spp=cfg.total_spp,
        seconds=best, segments=int(stats["segments"]), camera_rays=cfg.num_cells * cfg.spp,
        iters=int(stats["iters"]), lanes=int(stats["lanes"]), device=device_label(scene.device))
    print(rep.to_json(), flush=True)
    print(rep.summary(), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    args.device = _device(args)  # fails before any work, and before a trace is opened
    cmd = {"render": cmd_render, "invert": cmd_invert, "bench": cmd_bench}[args.cmd]
    with maybe_trace(args.profile_dir):
        if args.debug_nans:
            from .utils.debug import debug_context

            with debug_context(nans=True):
                return cmd(args)
        return cmd(args)


if __name__ == "__main__":
    raise SystemExit(main())
