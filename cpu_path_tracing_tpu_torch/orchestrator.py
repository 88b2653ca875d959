"""Fault-tolerant tile orchestrator.

Counterpart of ``cpu_path_tracing_tpu/orchestrator.py``.  The reference has
no failure handling: a failed row task crashes the process and loses the
render (``src/main.cpp:214-236``).  Here an image is rendered as tiles,
contiguous pixel-aligned cell spans, each ``render_cells_range(scene, cfg,
ids, 0, cfg.spp)`` on the scene's device (one launch of the forward kernel
on the card).  Two properties make that safe:

* idempotence: a tile's sums are a pure function of (scene, config, cell
  span, seed), since every draw is keyed by (seed, cell, sample)
  (ops/rng.py) and each cell's samples are added in sample order whatever
  the span (``ops/wavefront._cell_sums``).  So a retried tile gives the same
  bits, and a tiled image equals the untiled ``render.render_image`` bit for
  bit wherever that renders each cell's samples in one launch (below
  ``render.sample_chunk_for``'s item cap), for every ``tile_cells``;
* durability: with a checkpoint path, the sums and the done bitmap are saved
  after every tile (``TileState``, the JAX ``.npz`` keys), so a killed run
  resumes with only its missing tiles.

Any exception while a tile renders (a launch error, a lost device, an
injected fault) fails that attempt; the tile is retried on the same route
up to ``max_retries`` times, then ``TileRenderError`` is raised from the
last error.  A tile is never moved to another device or to a plain
version.  A CUDA error that poisons the context fails every retry the same
way and so surfaces through ``TileRenderError``.  ``FaultInjector`` fails
chosen tiles deterministically, for tests and drills.

The sums are kept in the scene's dtype (the JAX package keeps float32,
which rounds a float64 scene's sums), so the bitwise promise holds for
float64 scenes too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from .config import RenderConfig
from .models.scene import Scene
from .render import render_cells_range
from .utils.checkpoint import _final_image, _fingerprint, _host_dtype, _save_npz


class InjectedFault(RuntimeError):
    """Raised by FaultInjector to simulate a lost tile."""


class TileRenderError(RuntimeError):
    """A tile kept failing past ``max_retries`` retries."""


@dataclasses.dataclass
class FaultInjector:
    """Fail chosen tiles on their first ``times`` attempts.

    ``fail_tiles`` maps tile index -> attempts to fail.  Parsed from the CLI
    as ``TILE[:TIMES][,TILE[:TIMES]...]`` (``--inject-fault 3:2,7``)."""

    fail_tiles: dict = dataclasses.field(default_factory=dict)
    attempts: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def parse(spec: str) -> "FaultInjector":
        fail = {}
        for part in spec.split(","):
            if not part:
                continue
            tile, _, times = part.partition(":")
            fail[int(tile)] = int(times) if times else 1
        return FaultInjector(fail)

    def __call__(self, tile: int) -> None:
        n = self.attempts.get(tile, 0)
        self.attempts[tile] = n + 1
        if n < self.fail_tiles.get(tile, 0):
            raise InjectedFault(f"injected fault: tile {tile}, attempt {n}")


@dataclasses.dataclass
class TileState:
    """Durable orchestrator state: per-cell sums of the done tiles and the
    done bitmap."""

    sums: np.ndarray  # [num_cells, 3]
    done: np.ndarray  # [n_tiles] bool
    fingerprint: str
    tile_cells: int

    def save(self, path: str) -> None:
        _save_npz(path, sums=self.sums, done=self.done, fingerprint=self.fingerprint,
                  tile_cells=self.tile_cells)

    @staticmethod
    def load(path: str) -> "TileState":
        z = np.load(path, allow_pickle=False)
        return TileState(sums=z["sums"], done=z["done"].astype(bool),
                         fingerprint=str(z["fingerprint"]), tile_cells=int(z["tile_cells"]))


def tile_spans(cfg: RenderConfig, tile_cells: int):
    """Contiguous [start, end) cell spans of whole pixels, and the tile size
    used (``tile_cells`` rounded down to whole pixels, at least one)."""
    ns2 = cfg.num_subpixels * cfg.num_subpixels
    tile_cells = max(ns2, tile_cells - tile_cells % ns2)
    return [(s, min(s + tile_cells, cfg.num_cells))
            for s in range(0, cfg.num_cells, tile_cells)], tile_cells


def render_tiled(scene: Scene, cfg: RenderConfig, *, tile_cells: Optional[int] = None,
                 checkpoint_path: Optional[str] = None, max_retries: int = 2,
                 fault_injector: Optional[Callable[[int], None]] = None,
                 progress: Optional[Callable[[int, int], None]] = None,
                 render_fn: Optional[Callable] = None) -> torch.Tensor:
    """Render the image as independent retried tiles; returns the linear
    image [H,W,3] on the scene's device.  ``render_fn(scene, ids, start,
    n)`` renders one tile, its cells ``ids`` a host ``range`` (default
    ``render_cells_range``); tests pass one to count the tiles rendered."""
    spans, tile_cells = tile_spans(cfg, tile_cells or cfg.num_cells)
    n_tiles = len(spans)
    fp = _fingerprint(scene, cfg) + f"/spp{cfg.spp}/tc{tile_cells}"

    state = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = TileState.load(checkpoint_path)
        if state.fingerprint != fp:
            raise ValueError(f"checkpoint {checkpoint_path} was written for a different "
                             f"scene/config/tiling ({state.fingerprint} != {fp})")
    if state is None:
        state = TileState(sums=np.zeros((cfg.num_cells, 3), _host_dtype(scene)),
                          done=np.zeros(n_tiles, bool), fingerprint=fp, tile_cells=tile_cells)
    if render_fn is None:
        def render_fn(sc, ids, start, n):
            return render_cells_range(sc, cfg, ids, start, n)

    n_done = int(state.done.sum())
    for tile, (s, e) in enumerate(spans):
        if state.done[tile]:
            continue
        ids = range(s, e)
        last_err: Optional[Exception] = None
        for _attempt in range(max_retries + 1):
            try:
                if fault_injector is not None:
                    fault_injector(tile)
                out = render_fn(scene, ids, 0, cfg.spp).cpu().numpy()
                break
            except Exception as err:  # noqa: BLE001 - any loss of a tile retries it
                last_err = err
        else:
            raise TileRenderError(f"tile {tile} (cells [{s},{e})) failed "
                                  f"{max_retries + 1} times") from last_err
        state.sums[s:e] = out
        state.done[tile] = True
        n_done += 1
        if checkpoint_path:
            state.save(checkpoint_path)
        if progress:
            progress(n_done, n_tiles)

    return _final_image(state.sums, cfg.spp, cfg, scene.device)
