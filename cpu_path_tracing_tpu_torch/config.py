"""Render configuration.

Counterpart of ``cpu_path_tracing_tpu/config.py``: the same estimator
fields with the same defaults (1024x768, 2x2 subpixels, 1 sample per
subpixel, max depth 100, Russian roulette after depth 4 — the reference
binary's ``src/main.cpp:106,202-206`` and ``src/constants.hpp:7-10``).

The TPU schedule knobs of the JAX config (``wavefront_lanes``,
``wavefront_ring``, ``pallas_*``) are gone: the CUDA kernel sizes its own
grid from the card's occupancy (``csrc/megakernel.cu``), and the plain
PyTorch path needs no schedule.
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
    # Bounce loop of the plain path.  Only 'while' (early exit) is ported;
    # the reverse-mode 'scan' loop comes with the geometry backward (ROADMAP.md
    # Queue 1 item 8).
    loop: str = "while"
    # 'auto' = the CUDA kernel for a float32 scene on a CUDA device, the
    # plain PyTorch version for a scene on the CPU (render.resolve_integrator).
    integrator: str = "auto"
    # Subpixel jitter: 'uniform' (src/main.cpp:186-190) or 'tent' (the
    # sandbox smallpt filter, sandbox/main.cpp:253-256; plain path only).
    jitter: str = "uniform"

    @property
    def total_spp(self) -> int:
        return self.spp * self.num_subpixels * self.num_subpixels

    @property
    def num_cells(self) -> int:
        """Subpixel cells in the image (pixels x subpixels^2)."""
        return self.width * self.height * self.num_subpixels * self.num_subpixels

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
