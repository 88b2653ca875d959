"""Differentiable rendering and inverse rendering.

Counterpart of ``cpu_path_tracing_tpu/grad.py`` for the fields the analytic
replay covers (albedo, emission, background).  The rendered cell sum is a
``torch.autograd.Function``: its forward is ``render_cells_range`` (the
forward kernel on the card), its backward ``ops/replay.
replay_param_grads_auto`` (the replay kernel on the card), both on the
scene's device.  The loss lives in linear radiance on subpixel cells,
before the clamp of ``src/main.cpp:195-196``.

Geometry and camera gradients (the JAX package's rematerialized scan VJP,
with ``sample_chunk``, ``compact`` and its compaction schedule) are not
ported yet: a field outside ``OPTIMIZABLE_REPLAY`` raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import RenderConfig
from .models.scene import SPHERE_FIELDS, Scene
from .ops.kernels.replay import check_replay_config
from .ops.replay import replay_param_grads_auto
from .render import _on_cuda, render_cells_range

# Scene fields that may be optimized.
OPTIMIZABLE = ("p0", "radius", "albedo", "emission", "camera", "background")
# Fields whose gradients the analytic replay backward covers (multilinear in
# the estimator, ops/replay.py).
OPTIMIZABLE_REPLAY = ("albedo", "emission", "background")


def split_params(scene: Scene, fields=("p0", "radius", "albedo")) -> Dict[str, torch.Tensor]:
    """The optimizable fields of a scene, by name."""
    bad = set(fields) - set(OPTIMIZABLE)
    if bad:
        raise ValueError(f"cannot optimize {sorted(bad)}; allowed: {OPTIMIZABLE}")
    return {f: getattr(scene, f) for f in fields}


def merge_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    """A new Scene with ``params`` in place of the scene's fields; the scene
    itself is not changed."""
    fields = {f: getattr(scene, f) for f in SPHERE_FIELDS + ("background",)}
    fields.update({k: v for k, v in params.items() if k != "camera"})
    return Scene(**fields, camera=params.get("camera", scene.camera), ior=scene.ior)


def check_replay_fields(fields) -> None:
    """Raise ValueError for a field the replay backward does not cover."""
    bad = sorted(set(fields) - set(OPTIMIZABLE_REPLAY))
    if bad:
        raise ValueError(f"gradients of {bad} are not ported yet: only {OPTIMIZABLE_REPLAY} "
                         "(ROADMAP.md Queue 1: the geometry and camera backward)")


class _RenderSpan(torch.autograd.Function):
    """Per-cell radiance sum over a sample span; backward by the replay."""

    @staticmethod
    def forward(ctx, scene, cfg, cell_ids, sample_start, num_samples, names, *values):
        sc = merge_params(scene, dict(zip(names, values)))
        ctx.replay = (sc, cfg, cell_ids, sample_start, num_samples, names)
        return render_cells_range(sc, cfg, cell_ids, sample_start, num_samples)

    @staticmethod
    def backward(ctx, ct):
        sc, cfg, cell_ids, sample_start, num_samples, names = ctx.replay
        g = replay_param_grads_auto(sc, cfg, cell_ids, sample_start, num_samples, ct)
        return (None,) * 6 + tuple(g[k] for k in names)


def make_diff_render_span(scene: Scene, cfg: RenderConfig, spp_span: int):
    """Differentiable per-cell radiance SUM over ``spp_span`` samples from a
    ``sample_start``: ``render_sum(params, cell_ids, sample_start) -> [B,3]``,
    differentiable with respect to ``params`` (a dict of replay fields).

    On a CUDA scene, what the kernels do not do (float64, tent jitter, more
    than MAX_REPLAY_SPHERES spheres) raises here, before anything runs."""
    if _on_cuda(scene):
        check_replay_config(cfg, scene.dtype, scene.num_spheres)

    def render_sum(params, cell_ids, sample_start: int = 0):
        check_replay_fields(params)
        names = tuple(params)
        return _RenderSpan.apply(scene, cfg, cell_ids, int(sample_start), spp_span, names,
                                 *(params[k] for k in names))

    return render_sum


def make_diff_render(scene: Scene, cfg: RenderConfig):
    """Differentiable per-cell MEAN radiance over ``cfg.spp`` samples:
    ``render_mean(params, cell_ids) -> [B,3]``."""
    render_sum = make_diff_render_span(scene, cfg, cfg.spp)

    def render_mean(params, cell_ids):
        return render_sum(params, cell_ids, 0) / cfg.spp

    return render_mean


def make_accum_loss_grad(scene: Scene, cfg: RenderConfig, *, cell_chunk: Optional[int] = None):
    """The full-image loss and its gradient, accumulated over chunks.

    Returns ``loss_grad(params, targets) -> (loss, grads)``: ``loss`` is the
    full-image MSE against the [num_cells, 3] mean-radiance ``targets`` (a
    0-d tensor), ``grads`` its gradient with respect to each of ``params``,
    both summed over contiguous ``cell_chunk``-cell spans and divided by
    ``3 * num_cells`` once at the end (the chunk loop of the JAX package's
    ``make_accum_train_step``)."""
    n = cfg.num_cells
    cc = min(cell_chunk or n, n)
    render_mean = make_diff_render(scene, cfg)

    def loss_grad(params, targets):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        sq_sum = grads = None
        for start in range(0, n, cc):
            ids = torch.arange(start, min(start + cc, n), dtype=torch.int64, device=scene.device)
            sq = ((render_mean(leaves, ids) - targets[start:start + ids.shape[0]]) ** 2).sum()
            g = torch.autograd.grad(sq, tuple(leaves.values()))
            sq_sum = sq.detach() if sq_sum is None else sq_sum + sq.detach()
            grads = g if grads is None else tuple(a + b for a, b in zip(grads, g))
        denom = 3 * n
        return sq_sum / denom, {k: v / denom for k, v in zip(leaves, grads)}

    return loss_grad


def make_accum_train_step(scene: Scene, cfg: RenderConfig, lr: float, *,
                          cell_chunk: Optional[int] = None):
    """Inverse rendering at full image size: one Adam step per call.

    Returns ``step(params, targets) -> (params, loss)``.  ``targets`` is the
    [num_cells, 3] mean-radiance target; ``loss`` the full-image MSE (a 0-d
    tensor) at the given ``params``, which are updated once from the
    gradient of ``make_accum_loss_grad``.  The returned params are new
    tensors.

    The step keeps ``torch.optim.Adam`` (optax.adam's betas and eps) and its
    moments across calls: its first call takes the params to optimize, later
    calls continue from the params they are given."""
    loss_grad = make_accum_loss_grad(scene, cfg, cell_chunk=cell_chunk)
    state = {}

    def step(params, targets):
        if not state:
            state["params"] = {k: v.detach().clone().requires_grad_(True)
                               for k, v in params.items()}
            state["opt"] = torch.optim.Adam(state["params"].values(), lr=lr,
                                            betas=(0.9, 0.999), eps=1e-8)
        leaves, opt = state["params"], state["opt"]
        if set(params) != set(leaves):
            raise ValueError(f"step was built for {sorted(leaves)}, got {sorted(params)}")
        with torch.no_grad():
            for k, v in params.items():
                if v is not leaves[k]:
                    leaves[k].copy_(v)
        loss, grads = loss_grad(leaves, targets)
        for k, v in leaves.items():
            v.grad = grads[k]
        opt.step()
        return {k: v.detach().clone() for k, v in leaves.items()}, loss

    return step


def render_target(scene: Scene, cfg: RenderConfig, cell_chunk: Optional[int] = None):
    """Mean-radiance target [num_cells, 3] for inverse rendering, rendered on
    the scene's device in ``cell_chunk``-cell spans."""
    n = cfg.num_cells
    cc = min(cell_chunk or n, n)
    outs = []
    with torch.no_grad():
        for start in range(0, n, cc):
            ids = torch.arange(start, min(start + cc, n), dtype=torch.int64, device=scene.device)
            outs.append(render_cells_range(scene, cfg, ids, 0, cfg.spp) / cfg.spp)
    return torch.cat(outs, dim=0)
