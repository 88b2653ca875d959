"""Render configuration.

Counterpart of ``cpu_path_tracing_tpu/config.py``: the same estimator
fields with the same defaults (1024x768, 2x2 subpixels, 1 sample per
subpixel, max depth 100, Russian roulette after depth 4 — the reference
binary's ``src/main.cpp:106,202-206`` and ``src/constants.hpp:7-10``).

Of the JAX config's schedule knobs the port keeps ``loop``, ``remat``,
``compact_schedule`` (the differentiable bounce loop), ``integrator``,
``wavefront_lanes`` (the lane pool of the per-step paths) and
``pallas_persistent`` (the whole-render kernel or the per-step kernel).
``wavefront_ring``, ``pallas_rows`` and ``pallas_unroll`` are gone: the
port has no result ring (finished paths write their radiance straight to
the output), and the whole-render kernel sizes its own grid from the
card's occupancy (``csrc/megakernel.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (frozen, hashable)."""

    width: int = 1024
    height: int = 768
    # Samples per subpixel cell; total spp is spp * num_subpixels**2.
    spp: int = 1
    num_subpixels: int = 2
    max_depth: int = 100
    rr_depth: int = 4  # roulette when depth > rr_depth (src/main.cpp:130)
    seed: int = 0
    # Intersection epsilon and the "infinity" miss sentinel
    # (src/constants.hpp:7,9).
    epsilon: float = 1e-4
    inf: float = 1e20
    # Cells per render_cells call in render_image; None = the whole image.
    ray_chunk: Optional[int] = None
    # Bounce loop of the batch route (ops/integrator.radiance): 'while' stops
    # when no ray is alive (one host sync a bounce), 'scan' runs max_depth
    # bounces without a sync.  Both are differentiable under torch autograd
    # (dead rays are frozen by torch.where) and give the same radiance and
    # gradients.  'scan' with any integrator renders on the batch route.
    loop: str = "while"
    # Wrap each bounce of the batch route in torch.utils.checkpoint, so the
    # backward pass keeps only the per-bounce ray state and recomputes the
    # intersection and shading intermediates (JAX: jax.checkpoint).
    remat: bool = False
    # 'pallas' = the hand-written CUDA kernels (the JAX name, so configs and
    # CLI flags carry over; on CPU tensors their wrappers run the plain
    # versions); 'wavefront' = the plain PyTorch wavefront loop
    # (ops/wavefront.render_wavefront), any dtype and jitter; 'batch' = one
    # batch of the cells per sample through ops/integrator.radiance, any
    # cell-id set, differentiable; 'auto' = 'pallas' for a float32,
    # uniform-jitter scene on a CUDA device, else 'wavefront', and on the
    # CPU the plain version of the whole-render kernel
    # (render.resolve_integrator).
    integrator: str = "auto"
    # Lane-pool width of the per-step paths (render_wavefront and the
    # per-step kernel): items are striped over the pool, item = gen*B + lane.
    wavefront_lanes: int = 1 << 19
    # Subpixel jitter: 'uniform' (src/main.cpp:186-190) or 'tent' (the
    # sandbox smallpt filter, sandbox/main.cpp:253-256; the plain paths
    # only: the kernels' in-kernel camera has uniform jitter).
    jitter: str = "uniform"
    # integrator='pallas': True = the whole render in one kernel launch
    # (csrc/megakernel.cu); False = one launch of the per-step kernel per
    # wavefront iteration (csrc/megakernel_step.cu), the path of `cli bench`.
    pallas_persistent: bool = True
    # Live-ray compaction of the batch route (ops/integrator.radiance_compact):
    # a tuple of stage lengths in bounces covering max_depth; at each stage
    # boundary the rays still alive are gathered into a smaller batch.  None
    # = no compaction.  Built by grad.tune_backward_schedule.
    compact_schedule: Optional[tuple] = None

    @property
    def total_spp(self) -> int:
        return self.spp * self.num_subpixels * self.num_subpixels

    @property
    def num_cells(self) -> int:
        """Subpixel cells in the image (pixels x subpixels^2)."""
        return self.width * self.height * self.num_subpixels * self.num_subpixels

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
