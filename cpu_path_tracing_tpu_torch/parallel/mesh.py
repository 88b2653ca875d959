"""Device-mesh construction.

Counterpart of ``cpu_path_tracing_tpu/parallel/mesh.py``: a two-axis grid
of devices,

* ``tiles``: contiguous spans of subpixel cells (the counter RNG makes the
  image independent of the mesh shape);
* ``samples``: ranges of each cell's samples, summed over the axis.

The JAX package hands its grid to ``jax.sharding.Mesh`` and lets
``shard_map`` place the work; here ``Mesh`` is only the grid, and
``parallel/spmd.run`` runs ``parallel/render.py``'s and ``grad.py``'s
shards on all its entries at once, each entry on a CUDA stream of its own
(``parallel/cards.py`` gives each card a process for the accumulating step,
and ``parallel/distributed.py`` spreads the same grid over ranks).
An entry may name a device more than once, as JAX's virtual CPU devices
let a 4x2 mesh run on one host: the tests run ``['cpu'] * 8``, and a 2x2
mesh runs on one card as ``['cuda:0'] * 4``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A [n_tiles, n_samples] grid: ``devices[t][s]`` renders tile t's cells
    for sample shard s.  Its entries are ``torch.device``s, or ranks in a
    process group (``parallel/distributed.global_mesh``)."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: len(self.devices), SAMPLE_AXIS: len(self.devices[0])}

    def distinct_devices(self) -> list:
        """Each entry once, in row-major order of first appearance."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def make_mesh(n_tiles: Optional[int] = None, n_samples: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('tiles', 'samples') mesh, row-major over ``devices``.

    ``devices`` defaults to every visible CUDA device once, and ``n_tiles``
    to as many tiles as the devices fill; ``n_tiles * n_samples`` must equal
    the device count (``ValueError`` otherwise)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("no CUDA device is visible: pass devices= (e.g. ['cpu'] * 8)")
    devices = [torch.device(d) for d in devices]
    if n_tiles is None:
        n_tiles = len(devices) // n_samples
    if n_tiles < 1 or n_samples < 1 or n_tiles * n_samples != len(devices):
        raise ValueError(f"mesh {n_tiles}x{n_samples} != {len(devices)} devices")
    return Mesh(tuple(tuple(devices[t * n_samples:(t + 1) * n_samples])
                      for t in range(n_tiles)))
