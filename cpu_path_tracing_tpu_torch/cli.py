"""Command-line interface: the ``render``, ``invert`` and ``bench`` subcommands.

Counterpart of ``cpu_path_tracing_tpu/cli.py``'s ``render``, ``invert`` and
``bench`` without the mesh, tile, checkpoint and multi-host options:

    python -m cpu_path_tracing_tpu_torch.cli render --scene box_mirror \\
        --width 1024 --height 768 --total-spp 32 -o disco.png
    python -m cpu_path_tracing_tpu_torch.cli invert --scene box \\
        --width 400 --height 400 --spp 16 --steps 100
    python -m cpu_path_tracing_tpu_torch.cli bench --scene box_mirror --total-spp 32
    python -m cpu_path_tracing_tpu_torch.cli render --scene box --width 64 \\
        --height 48 --spp 2 --device cpu -o box.png

Every subcommand runs on the card (``--device cuda``, the default) and
fails before doing any work when there is none; ``--device cpu`` asks for
the CPU.  ``--profile-dir DIR`` captures a ``torch.profiler`` trace of the
command there (``utils/profiling.maybe_trace``).

``--integrator`` picks the route (``render.resolve_integrator``): 'pallas'
the CUDA kernels, 'wavefront' the plain wavefront loop, 'auto' the kernels
for a float32, uniform-jitter scene on the card.  ``bench`` times the
per-step path, as the JAX ``cmd_bench`` does: with 'auto' on the card the
per-step kernel, elsewhere ``render_wavefront``; one warm-up run, then the
best of ``--repeats`` (CUDA-event time on the card), and one
``RenderReport`` JSON line on stdout.

``--total-spp N`` keeps the reference's meaning (N / subpixels^2 samples
per subpixel cell, ``src/main.cpp:203-206``).  ``invert`` renders the
scene as the target, perturbs the ``--fields`` (any of ``grad.OPTIMIZABLE``:
p0, radius, albedo, emission, camera, background) with seeded normal noise
and fits them back with Adam, printing one JSON line per reported step.
Its backward is the replay for albedo, emission and background alone
(``--no-replay-backward`` turns it off), else the scan VJP recomputed
``--sample-chunk`` samples at a time, with live-ray compaction unless
``--no-compact-backward`` (``grad.make_diff_render_span``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import RenderConfig, get_scene, scene_names, write_png, write_ppm
from .render import render_image
from .utils.profiling import maybe_trace


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="box_mirror", choices=scene_names())
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
    p.add_argument("--profile-dir", default=None, help="capture a torch.profiler trace here")
    p.add_argument("--integrator", choices=("auto", "wavefront", "pallas"), default="auto")
    p.add_argument("--jitter", choices=("uniform", "tent"), default="uniform",
                   help="subpixel filter: uniform (reference binary) or tent (sandbox "
                        "smallpt; the plain paths only)")
    p.add_argument("--lanes", type=int, default=None,
                   help="lane-pool width of the per-step paths (default 1<<19)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cpu_path_tracing_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="render a registered scene to PNG or PPM")
    _add_common(p)
    p.add_argument("-o", "--out", default="image.png", help=".png or .ppm")
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
                   help="use the scan VJP even when every field is a replay field")
    p = sub.add_parser("bench", help="time the per-step wavefront render")
    _add_common(p)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--suite", action="store_true",
                   help="not ported (ROADMAP.md Queue 1: the benchmark suite)")
    p.add_argument("--scaling", action="store_true",
                   help="not ported (ROADMAP.md Queue 1: parallel/ on torch.distributed)")
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


def _device(args) -> torch.device:
    """The device asked for; a CUDA device that is not there is an error,
    never a silent move to the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return device


def cmd_render(args) -> int:
    cfg = _config(args)
    scene = get_scene(args.scene, cfg.width, cfg.height).to(args.device)
    t0 = time.perf_counter()
    img = render_image(scene, cfg).cpu()  # the copy waits for the device
    seconds = time.perf_counter() - t0
    (write_ppm if args.out.endswith(".ppm") else write_png)(args.out, img)
    print(f"{args.scene} {cfg.width}x{cfg.height} @ {cfg.total_spp} total spp on "
          f"{scene.device} -> {args.out} in {seconds:.2f}s", file=sys.stderr)
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

    cfg = _config(args)
    fields = tuple(args.fields.split(","))
    scene = get_scene(args.scene, cfg.width, cfg.height).to(args.device)
    true_params = split_params(scene, fields)  # raises for a field outside OPTIMIZABLE
    t0 = time.perf_counter()
    target = render_target(scene, cfg, args.cell_chunk)
    print(f"target rendered in {time.perf_counter() - t0:.2f}s", file=sys.stderr)

    params = perturbed_params(true_params, args.seed, args.perturb)
    step_fn = make_accum_train_step(scene, cfg, args.lr, cell_chunk=args.cell_chunk,
                                    sample_chunk=args.sample_chunk,
                                    compact=not args.no_compact_backward,
                                    replay=not args.no_replay_backward)
    t0 = time.perf_counter()
    for step in range(args.steps):
        params, loss = step_fn(params, target)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            loss = float(loss)  # waits for the device
            sps = (step + 1) / (time.perf_counter() - t0)
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


def cmd_bench(args) -> int:
    if args.suite or args.scaling or args.ring is not None:
        raise SystemExit("bench --suite and --scaling are not ported yet (ROADMAP.md Queue 1: "
                         "the benchmark suite; parallel/ on torch.distributed), nor --ring: "
                         "the port has no result ring")
    from .ops.wavefront import render_wavefront, render_wavefront_per_step
    from .render import resolve_integrator
    from .utils.metrics import RenderReport

    cfg = _config(args)
    scene = get_scene(args.scene, cfg.width, cfg.height).to(args.device)
    render_span = (render_wavefront_per_step if resolve_integrator(scene, cfg) == "pallas"
                   else render_wavefront)
    ids = torch.arange(cfg.num_cells, device=scene.device)

    def run():
        return render_span(scene, cfg, ids, 0, cfg.spp, with_stats=True)

    _, stats = run()  # warm-up; the stats are deterministic and read once, untimed
    on_cuda = scene.device.type == "cuda"
    best = None
    for _ in range(args.repeats):
        if on_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run()
            dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    rep = RenderReport(
        scene=args.scene, width=cfg.width, height=cfg.height, total_spp=cfg.total_spp,
        seconds=best, segments=int(stats["segments"]), camera_rays=cfg.num_cells * cfg.spp,
        iters=int(stats["iters"]), lanes=int(stats["lanes"]),
        device=torch.cuda.get_device_name(scene.device) if on_cuda else str(scene.device))
    print(rep.to_json(), flush=True)
    print(rep.summary(), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    args.device = _device(args)  # fails before any work, and before a trace is opened
    with maybe_trace(args.profile_dir):
        return {"render": cmd_render, "invert": cmd_invert, "bench": cmd_bench}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
