"""Sharded rendering over a ('tiles', 'samples') mesh in one process.

Counterpart of ``cpu_path_tracing_tpu/parallel/render.py``.  Tile t renders
cells ``[t*per, (t+1)*per)`` (``per = ceil(num_cells / n_tiles)``); sample
shard s of the tile renders its samples ``[s*spp_local, (s+1)*spp_local)``,
each shard one ``render.render_cells_range`` call on its device (one launch
of the forward kernel on the card).  Every shard runs at once, each on a
stream of its own (``spmd.run``, the JAX ``shard_map``), and every shard's
launch is enqueued before any result crosses devices.  Then
the shards' sums are added on the tile's first device in sample-shard order
(s = 0, 1, ...), the one-process form of the JAX ``psum``, and divided by
``cfg.spp`` there.

The last tile is padded to ``per`` cells with ids that continue past
``num_cells``: every route renders a contiguous span, so JAX's padding by
cell 0 would be rejected; the padded cells are dropped before
``finalize_image``.

Keys depend only on (seed, cell, sample) (``ops/rng.py``) and every route
sums a cell's samples in sample order, so a tiles-only mesh gives the
one-pass image bit for bit; a sample axis re-associates each cell's sum.
"""

from __future__ import annotations

import copy

import torch

from ..config import RenderConfig
from ..models.scene import Scene
from ..render import finalize_image, render_cells_range
from . import spmd
from .mesh import SAMPLE_AXIS, TILE_AXIS, Mesh, make_mesh


def tile_span(cfg: RenderConfig, n_tiles: int) -> int:
    """Cells a tile renders, the last tile padded past ``num_cells``."""
    return -(-cfg.num_cells // n_tiles)


def samples_per_shard(cfg: RenderConfig, n_samples: int) -> int:
    if cfg.spp % n_samples:
        raise ValueError(f"spp={cfg.spp} not divisible by sample-axis size {n_samples}")
    return cfg.spp // n_samples


def replicate_scene(scene: Scene, mesh: Mesh) -> dict:
    """The scene on each distinct device of the mesh: {device: Scene}, the
    scene itself where it lives and a copy on every other device
    (``nn.Module.to`` moves a module in place, so it is never called on the
    caller's scene)."""
    return {d: scene if d == scene.device else copy.deepcopy(scene).to(d)
            for d in mesh.distinct_devices()}


def sum_shards(parts, device) -> torch.Tensor:
    """The sample shards' sums added in shard order (s = 0, 1, ...) on
    ``device``: one association for every mesh with this sample axis."""
    acc = parts[0].to(device)
    for part in parts[1:]:
        acc = acc + part.to(device)
    return acc


def render_cells_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """Mean radiance per cell [num_cells, 3], computed over the mesh and
    returned on its first device."""
    n_tiles = mesh.shape[TILE_AXIS]
    spp_local = samples_per_shard(cfg, mesh.shape[SAMPLE_AXIS])
    per = tile_span(cfg, n_tiles)
    scenes = replicate_scene(scene, mesh)
    first = mesh.devices[0][0]

    def shard(t, s, dev):
        start = t * per
        if start >= cfg.num_cells:
            return None  # a tile of padding alone
        return render_cells_range(scenes[dev], cfg, range(start, start + per),
                                  s * spp_local, spp_local)

    sums = spmd.run(mesh, shard)
    outs = []
    for t, row in enumerate(mesh.devices):
        start = t * per
        if start >= cfg.num_cells:
            break
        means = sum_shards(sums[t], row[0]) / cfg.spp
        outs.append(means[:cfg.num_cells - start].to(first))
    return torch.cat(outs, dim=0)


def render_image_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh | None = None):
    """Full sharded render -> linear image [H,W,3] (top row first), on the
    mesh's first device."""
    if mesh is None:
        mesh = make_mesh()
    return finalize_image(render_cells_sharded(scene, cfg, mesh), cfg)
