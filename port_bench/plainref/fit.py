"""The inverse step: full-image loss, its gradient by autograd, and Adam.

The loss is the mean squared error of every cell's mean radiance against
the target, over the three channels, in linear radiance before the clamp.
It is summed chunk by chunk in cell order and divided by ``3 * cells``
once.  A block of cells' sums is rendered under autograd and contracted
at once with each cell's cotangent ``2 * (mean - target) / spp``, which
needs no other cell.  Adam is torch's (betas 0.9, 0.999, eps
1e-8, bias-corrected), written out.
"""

from __future__ import annotations

import math

import torch

from .render import cell_sums
from .scene import camera_frame, with_params


def loss_and_grads(scene, render: dict, spp: int, seed: int, params: dict, target,
                   chunk: int, block: int):
    """(loss, {name: gradient}) at ``params`` (leaf name -> tensor), in one
    pass: a block of cells' sums under autograd, contracted at once with
    their cotangents ``2 * (mean - target) / spp``; a chunk's squared error
    summed over the chunk's cells."""
    n = target.shape[0]
    frame = camera_frame(scene.camera)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    at = with_params(scene, leaves)
    sq_sum = None
    with torch.enable_grad():
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            diffs = []
            for b0 in range(c0, c1, block):
                b1 = min(b0 + block, c1)
                sums = cell_sums(at, render, b0, b1, spp, seed, frame)
                diff = sums.detach() / spp - target[b0:b1]
                (2.0 * diff / spp * sums).sum().backward()
                diffs.append(diff)
            sq = (torch.cat(diffs) ** 2).sum()
            sq_sum = sq if sq_sum is None else sq_sum + sq
    denom = 3 * n
    return sq_sum.detach() / denom, {k: v.grad / denom for k, v in leaves.items()}


class Adam:
    """torch.optim.Adam's update for a dict of tensors."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t, self.m, self.v = 0, {}, {}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p)).lerp(g, 1 - self.b1)
            v = self.v.get(k, torch.zeros_like(p)) * self.b2 + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            out[k] = p - (self.lr / bc1) * m / (v.sqrt() / math.sqrt(bc2) + self.eps)
        return out


def follow(scene, render: dict, spp: int, seed: int, start: dict, target, lr: float,
           steps: int, chunk: int, block: int):
    """``steps`` Adam steps from ``start``: (the loss at each step's params,
    the first step's gradients, the params after the last step)."""
    opt, params = Adam(lr), dict(start)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads(scene, render, spp, seed, params, target, chunk, block)
        losses.append(float(loss))
        first = first or grads
        params = opt.step(params, grads)
    return losses, first, params
