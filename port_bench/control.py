"""Runs of a cell with another program in the port's place, for the limits
of its check.

    python3 port_bench/control.py --workload <name> --mode <mode> --seeds 1,2,3 [--seconds 1]

``--mode``:
  sound          the port itself (the lower readings);
  control        the benchmark's plain reference in bfloat16, the precision
                 below the configuration's float32 (the upper readings);
  stale          an image: the previous image returned again;
  half           half of the batch left out, the mean taken over the rest: an
                 image from half its samples (from half of each pixel's
                 subpixel cells at one sample a cell); a step whose loss and
                 gradient cover every other chunk of cells;
  altered        an answer altered where it is produced: one pixel channel
                 moved by 1/255; a step whose emission gradient is 1.5 times
                 the port's;
  altered_geometry  a step whose p0 and radius gradients (the geometry
                 backward's output, K7's on the card) are 1.5 times the
                 port's;
  unchanged      a step that returns its parameters unchanged.

Each seed is one run through the harness (set-up, a window of ``--seconds``
that at least reaches the images the check compares, the check), all in
this process; each prints the harness's result line.  The benchmark's own
runs never use this file.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402

from harness import port, runner  # noqa: E402
from harness.spec import Cell  # noqa: E402
from plainref import fit as ref_fit  # noqa: E402
from plainref import render as ref_render  # noqa: E402
from plainref.scene import build_scene  # noqa: E402

CONTROL_DTYPE = torch.bfloat16
ONE_LEVEL = 1.0 / 255


class RefImages:
    """``render`` by the plain reference in ``dtype``."""

    def __init__(self, config: dict, device, dtype=CONTROL_DTYPE):
        self.config, self.scene = config, build_scene(config, device, dtype)

    def render(self, spp: int, seed: int):
        with torch.no_grad():
            means = ref_render.cell_means(self.scene, self.config, spp, seed,
                                          max(1, (1 << 23) // spp))
        return ref_render.finalize(means, self.config).float()


class FaultyImages:
    """The port's render with one of the image faults of the module
    docstring."""

    def __init__(self, mode: str, cell, device):
        if mode not in ("stale", "half", "altered"):
            raise ValueError(f"no mode {mode!r} for an image cell")
        self.mode, self.config = mode, cell.config
        self.port = cell.loop().Port(cell.config, device)
        self.held = None

    def render(self, spp: int, seed: int):
        if self.mode == "stale":
            if self.held is None:
                self.held = self.port.render(spp, seed)
            return self.held
        if self.mode == "altered":
            img = self.port.render(spp, seed)
            img[img.shape[0] // 2, img.shape[1] // 2, 0] += ONE_LEVEL
            return img
        if spp >= 2:
            return self.port.render(spp // 2, seed)
        from cpu_path_tracing_tpu_torch.render import finalize_image, render_cells

        cfg = port.render_config(self.config, spp, seed)
        ns2 = cfg.num_subpixels ** 2
        ids = torch.arange(cfg.num_cells, device=self.port.scene.device)
        means = render_cells(self.port.scene, cfg, ids).reshape(-1, ns2, 3)
        half = means[:, : ns2 // 2].mean(dim=1, keepdim=True).expand(-1, ns2, 3)
        return finalize_image(half.reshape(-1, 3), cfg)


def image_program(mode: str, cell, device):
    if mode == "control":
        return RefImages(cell.config, device)
    return FaultyImages(mode, cell, device)


class RefStep:
    """Adam steps on the plain reference's loss and gradient in ``dtype``,
    with the step interface of the port's ``make_accum_train_step``."""

    def __init__(self, config: dict, scene, seed: int, dtype):
        self.config, self.scene, self.seed, self.dtype = config, scene, seed, dtype
        self.adam, self.names = ref_fit.Adam(config["lr"]), None

    def __call__(self, params, target):
        self.names = tuple(sorted(params))
        p = {k: v.to(self.dtype) for k, v in params.items()}
        spp = self.config["spp"]
        loss, grads = ref_fit.loss_and_grads(self.scene, self.config, spp, self.seed, p, target,
                                             self.config["cell_chunk"], max(1, (1 << 21) // spp))
        new = self.adam.step(p, grads)
        return {k: v.float() for k, v in new.items()}, loss.float()

    def leaf_names(self):
        return self.names

    def state_dict(self):
        return {"optimizer": {"state": {i: {"exp_avg": self.adam.m[n]}
                                        for i, n in enumerate(self.names)}}}

    def load_state_dict(self, sd):
        self.adam = ref_fit.Adam(self.config["lr"])


class RefFit:
    def __init__(self, config: dict, device, render_seed: int, dtype=CONTROL_DTYPE):
        self.config, self.dtype, self.seed = config, dtype, render_seed
        self.scene = build_scene(config, device, dtype)

    def target(self):
        with torch.no_grad():
            return ref_render.cell_means(self.scene, self.config, self.config["spp"], self.seed,
                                         max(1, (1 << 23) // self.config["spp"]))

    def make_step(self):
        return RefStep(self.config, self.scene, self.seed, self.dtype)


def half_batch_step(config: dict, scene, cfg):
    """Loss and gradient over every other chunk of cells, the mean taken
    over the cells counted, through the port's span and Adam."""
    from cpu_path_tracing_tpu_torch import grad

    span = grad.make_diff_render_span(scene, cfg, cfg.spp, config["sample_chunk"])
    n, chunk = cfg.num_cells, config["cell_chunk"]

    def loss_grad(params, targets):
        names, values = grad.flatten_params(params)
        leaves = [v.detach().requires_grad_(True) for v in values]
        at = grad.unflatten_params(names, leaves)
        sq = total = None
        counted = 0
        for c0 in range(0, n, 2 * chunk):
            ids = torch.arange(c0, min(c0 + chunk, n), device=scene.device)
            sums = span(at, ids, 0)
            diff = sums.detach() / cfg.spp - targets[ids]
            s = (diff ** 2).sum()
            g = torch.autograd.grad(sums, leaves, grad_outputs=2.0 * diff / cfg.spp)
            sq = s if sq is None else sq + s
            total = list(g) if total is None else [a + b for a, b in zip(total, g)]
            counted += ids.numel()
        denom = 3 * counted
        return sq / denom, grad.unflatten_params(names, [t / denom for t in total])

    return grad._adam_step(loss_grad, config["lr"])


def altered_step(config: dict, scene, cfg, leaves=("emission",)):
    """The port's step with the gradients of ``leaves`` made 1.5 times what
    the port's loss_grad gives."""
    from cpu_path_tracing_tpu_torch import grad

    lg = grad.make_accum_loss_grad(scene, cfg, cell_chunk=config["cell_chunk"],
                                   sample_chunk=config["sample_chunk"])

    def loss_grad(params, targets):
        loss, g = lg(params, targets)
        for name in leaves:
            g[name] = g[name] * 1.5
        return loss, g

    return grad._adam_step(loss_grad, config["lr"])


def unchanged_step(step):
    """The port's step, returning the parameters it was given."""
    def call(params, target):
        _, loss = step(params, target)
        return params, loss

    for name in ("state_dict", "load_state_dict", "leaf_names"):
        setattr(call, name, getattr(step, name))
    return call


def fit_program(mode: str, cell, device, seed: int):
    from harness.stats import derive

    drv = cell.loop()
    render_seed = derive(seed, drv.SEED_RENDER)
    if mode == "control":
        return RefFit(cell.config, device, render_seed)
    prog = drv.Port(cell.config, device, render_seed)
    make = {"half": lambda: half_batch_step(cell.config, prog.scene, prog.cfg),
            "altered": lambda: altered_step(cell.config, prog.scene, prog.cfg),
            "altered_geometry": lambda: altered_step(cell.config, prog.scene, prog.cfg,
                                                     ("p0", "radius")),
            "unchanged": lambda: unchanged_step(drv.Port.make_step(prog))}
    if mode not in make:
        raise ValueError(f"no mode {mode!r} for a fit cell")
    prog.make_step = make[mode]
    return prog


def program_for(mode: str, cell, device, seed: int):
    if mode == "sound":
        return None
    if cell.loop().Cell.unit == "image":
        return image_program(mode, cell, device)
    return fit_program(mode, cell, device, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog = program_for(args.mode, cell, device, seed)
        print(f"== {args.workload} mode {args.mode} seed {seed}", flush=True)
        runner.run(cell, seed, args.seconds, False, device, t0, program=prog)
    return 0


if __name__ == "__main__":
    sys.exit(main())
