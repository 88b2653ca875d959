"""Command-line interface: the ``render`` subcommand.

Counterpart of ``cpu_path_tracing_tpu/cli.py``'s ``render`` without the
mesh, tile, checkpoint and multi-host options:

    python -m cpu_path_tracing_tpu_torch.cli render --scene box_mirror \\
        --width 1024 --height 768 --total-spp 32 --device cuda -o disco.png

``--total-spp N`` keeps the reference's meaning (N / subpixels^2 samples
per subpixel cell, ``src/main.cpp:203-206``).
"""

from __future__ import annotations

import argparse
import sys
import time

from . import RenderConfig, get_scene, scene_names, write_png, write_ppm
from .render import render_image


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cpu_path_tracing_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="render a registered scene to PNG or PPM")
    p.add_argument("--scene", default="box_mirror", choices=scene_names())
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    sp = p.add_mutually_exclusive_group()
    sp.add_argument("--spp", type=int, default=None, help="samples per subpixel cell")
    sp.add_argument("--total-spp", type=int, default=None,
                    help="total spp as in the reference CLI (divided by subpixels^2)")
    p.add_argument("--max-depth", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cpu", help="torch device, e.g. cpu or cuda")
    p.add_argument("-o", "--out", default="render.png", help=".png or .ppm")
    return ap


def _config(args) -> RenderConfig:
    ns = RenderConfig.num_subpixels
    spp = args.spp
    if spp is None:
        total = args.total_spp if args.total_spp is not None else 4
        spp = max(1, total // (ns * ns))
    return RenderConfig(width=args.width, height=args.height, spp=spp,
                        max_depth=args.max_depth, seed=args.seed)


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


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    return {"render": cmd_render}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
