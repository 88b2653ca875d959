"""Whole-render launch over a contiguous cell span.

Counterpart of ``render_wavefront_pallas_persistent``
(``cpu_path_tracing_tpu/ops/wavefront.py:374-453``): pack the scene, render
every (cell, sample) item of the span in one call of the kernel wrapper
(``ops/kernels/megakernel.py``; the plain PyTorch version when the scene is
on the CPU), then sum each cell's samples in sample order.

Per-item radiance depends only on (seed, cell, sample) through the item
keys (ops/rng.py), so results are independent of the kernel's schedule.
"""

from __future__ import annotations

from ..config import RenderConfig
from .kernels.megakernel import pack_camera, pack_scene, persistent_render


def render_wavefront_persistent(scene, cfg: RenderConfig, cell_ids, sample_start: int,
                                num_samples: int, *, with_stats: bool = False):
    """SUM of radiance over samples [sample_start, sample_start+num_samples)
    for each cell of ``cell_ids``, a contiguous ascending span.  Returns
    [n_cells, 3] in the scene's dtype, plus ``{segments, iters, lanes}``
    when asked (ops/kernels/megakernel.py defines them)."""
    from ..render import check_contiguous_cells  # render imports this module

    check_contiguous_cells(cell_ids)
    n_cells = int(cell_ids.shape[0])
    cell_start = int(cell_ids[0]) if n_cells else 0
    dtype = scene.dtype
    table = pack_scene(scene, dtype)
    cam = pack_camera(scene, dtype)
    n_items = n_cells * num_samples
    out, stats = persistent_render(table, cam, (cell_start, sample_start), cfg=cfg,
                                   n_cells=n_cells, n_items=n_items, ior=scene.ior)
    # Sample-major, in sequence: the association order of the JAX package's
    # per-cell reduction (it is plain XLA outside the TPU kernel, too).
    per_sample = out.view(3, num_samples, n_cells)
    sums = per_sample[:, 0].clone()
    for i in range(1, num_samples):
        sums += per_sample[:, i]
    sums = sums.T.contiguous()
    if with_stats:
        return sums, stats
    return sums
