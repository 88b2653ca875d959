"""Images back to back, one client: each image is rendered, waited for,
and then the next is asked for (a closed loop).

The traffic file gives the samples an image takes (``total_spp``), which
images the check compares with the reference (``check_images``: that many
less one drawn from the seed among the first ``check_from``, and the
window's last), which images a traced run profiles (``profile_from``,
``profiled``) and the limit of each number compared (``limits``).  Each
image's render seed is drawn from the run's seed and the image's index,
so no two images repeat one another and every image has the same size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness import port
from harness.stats import derive
from plainref import render as ref_render
from plainref.scene import build_scene

RAYS_PER_BLOCK = 1 << 23  # the reference's batch, in (cell, sample) items
SEED_IMAGE, SEED_WARMUP, SEED_CHECK = 1, 2, 3


class Port:
    """The system under test: ``render_image`` of the port."""

    def __init__(self, config: dict, device):
        self.config, self.scene = config, port.scene(config, device)

    def render(self, spp: int, seed: int):
        import cpu_path_tracing_tpu_torch as tp

        return tp.render_image(self.scene, port.render_config(self.config, spp, seed))


class Cell:
    unit = "image"

    def __init__(self, config: dict, traffic: dict, seed: int, device, program=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        ns2 = config["num_subpixels"] ** 2
        if traffic["total_spp"] % ns2:
            raise ValueError(f"total_spp {traffic['total_spp']} is no multiple of {ns2}")
        self.spp = traffic["total_spp"] // ns2
        self.program = program
        draws = np.random.default_rng(derive(seed, SEED_CHECK)).choice(
            traffic["check_from"], size=traffic["check_images"] - 1, replace=False)
        self.sampled = {int(i) for i in draws}
        self.min_units = max(self.sampled, default=-1) + 1
        first = traffic["profile_from"]
        self.profiled = list(range(first, first + traffic["profiled"]))
        self.kept, self.last = {}, None

    def image_seed(self, i: int) -> int:
        return derive(self.seed, SEED_IMAGE, i)

    def setup(self) -> None:
        self.program = self.program or Port(self.config, self.device)
        self.program.render(self.spp, derive(self.seed, SEED_WARMUP))
        _sync(self.device)

    def prepare(self, i: int) -> None:
        pass

    def run(self, i: int):
        img = self.program.render(self.spp, self.image_seed(i))
        _sync(self.device)
        return img

    def settle(self, i: int, img):
        """The image's verdict, judged after the window: finite or not.  A
        profiled image is held whole, so that nothing of the harness's runs
        on the card in the traced stretch; any other is reduced to its sum
        (one launch, no wait: a sum of values clamped to [0, 1] is finite
        exactly where every value is)."""
        if i in self.sampled:
            self.kept[i] = img
        self.last = (i, img)
        if i in self.profiled:
            return lambda: bool(torch.isfinite(img).all())
        total = img.sum()
        return lambda: math.isfinite(float(total))

    def release(self) -> None:
        self.program = None
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1]
        self.last = None

    def _block(self) -> int:
        return max(1, RAYS_PER_BLOCK // self.spp)

    def check(self) -> list:
        """The worst pixel channel's distance from the reference's image,
        over the kept images: [(name, value, limit)]."""
        scene = build_scene(self.config, self.device)
        worst = 0.0
        for i, img in sorted(self.kept.items()):
            with torch.no_grad():
                ref = ref_render.finalize(ref_render.cell_means(
                    scene, self.config, self.spp, self.image_seed(i), self._block()), self.config)
            dev = float((img.to(ref.dtype) - ref).abs().max())
            worst = dev if not dev <= worst else worst
        return [("px_dev_max", worst, self.traffic["limits"]["px_dev_max"])]

    def counts(self) -> dict:
        """The work of each profiled image's render launch, counted by the
        reference over the same inputs."""
        scene = build_scene(self.config, self.device)
        n_cells = self.config["width"] * self.config["height"] * self.config["num_subpixels"] ** 2
        launches = []
        for i in self.profiled:
            with torch.no_grad():
                _, c = ref_render.cell_means(scene, self.config, self.spp, self.image_seed(i),
                                             self._block(), count=True)
            launches.append(dict(c, n_spheres=int(scene.radius.shape[0]), cells=n_cells,
                                 items=n_cells * self.spp))
        return {"k2": launches}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
