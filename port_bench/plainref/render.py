"""Cell sums and images.

The image is a flat array of subpixel cells, ``cell = (y*W + x) * ns^2 +
sy*ns + sx`` with y = 0 the bottom row.  A (cell, sample) item's camera ray
is jittered within its subpixel by the item key's words and goes through
the lens disk by the next block's pair.  A cell's sum adds its samples in
sample order; the image clamps every cell mean to [0, 1] before the
subpixels of a pixel are averaged (``src/main.cpp:195-196``), top row
first.
"""

from __future__ import annotations

import torch

from . import rng
from .paths import trace
from .scene import camera_frame, primary_rays


def item_rays(scene, frame, render: dict, cells, samples, seed: int):
    """(item keys, origins [B,3], directions [B,3]) of (cell, sample) items."""
    dtype = scene.p0.dtype
    a0, a1 = rng.item_keys(seed, cells, samples)
    u = rng.camera_uniforms(a0, a1).to(dtype)
    ns, width, height = render["num_subpixels"], render["width"], render["height"]
    sub, pix = cells % (ns * ns), cells // (ns * ns)
    x, y, sx, sy = pix % width, pix // width, sub % ns, sub // ns
    sub_len = 1.0 / ns
    x_in = x.to(dtype) + sx.to(dtype) * sub_len + u[:, 0] * sub_len
    y_in = y.to(dtype) + sy.to(dtype) * sub_len + u[:, 1] * sub_len
    o, d = primary_rays(frame, x_in * (1.0 / width), y_in * (1.0 / height), u[:, 2], u[:, 3])
    return (a0, a1), o, d


def cell_sums(scene, render: dict, c0: int, c1: int, spp: int, seed: int, frame=None,
              count=False):
    """Radiance summed over samples ``0..spp-1`` of cells ``[c0, c1)``, in
    sample order: [c1 - c0, 3] (and the work counts with ``count``)."""
    dev = scene.p0.device
    frame = frame or camera_frame(scene.camera)
    nc = c1 - c0
    cells = torch.arange(c0, c1, device=dev).repeat(spp)
    samples = torch.arange(spp, device=dev).repeat_interleave(nc)
    keys, o, d = item_rays(scene, frame, render, cells, samples, seed)
    got = trace(scene, o, d, keys, max_depth=render["max_depth"], rr_depth=render["rr_depth"],
                epsilon=render["epsilon"], inf=render["inf"], count=count)
    rad, counts = got if count else (got, None)
    per = rad.view(spp, nc, 3)
    if torch.is_grad_enabled():
        sums = per[0]
        for i in range(1, spp):
            sums = sums + per[i]
    else:
        sums = per[0].clone()
        for i in range(1, spp):
            sums += per[i]
    return (sums, counts) if count else sums


def cell_means(scene, render: dict, spp: int, seed: int, block: int, count=False):
    """Every cell's mean over ``spp`` samples, [num_cells, 3], rendered
    ``block`` cells at a time (and the summed work counts with ``count``)."""
    n = render["width"] * render["height"] * render["num_subpixels"] ** 2
    frame = camera_frame(scene.camera)
    outs, total = [], {}
    for c0 in range(0, n, block):
        got = cell_sums(scene, render, c0, min(c0 + block, n), spp, seed, frame, count)
        sums, counts = got if count else (got, {})
        outs.append(sums / spp)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    means = torch.cat(outs, dim=0)
    return (means, total) if count else means


def finalize(means, render: dict):
    """Cell means [num_cells, 3] -> image [H, W, 3], top row first."""
    ns2 = render["num_subpixels"] ** 2
    c = torch.clamp(means, 0.0, 1.0)
    pixels = c.reshape(render["height"], render["width"], ns2, 3).mean(dim=2)
    return torch.flip(pixels, dims=(0,))
