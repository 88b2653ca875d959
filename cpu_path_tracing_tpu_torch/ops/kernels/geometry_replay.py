"""The geometry replay kernel: wrapper, plain version and gradient entry.

``geometry_replay`` computes in one launch the p0, radius and camera
partials of a span's backward (``ops/geometry_replay.py`` has the algebra
and the layout, ``[4N+14]``) with a CUDA C++ kernel for Hopper,
``csrc/geometry_replay.cu``.  The JAX package has no kernel here: it runs
this backward as XLA's autodiff of its checkpointed scan
(``cpu_path_tracing_tpu/grad.py``), which the port's scan VJP
(``grad._scan_vjp``) carries over as eager autograd, thousands of small
launches a bounce.

The kernel is the replay kernel's skeleton (``csrc/replay.cu``): a
persistent grid, one live path a thread over warp-owned chunks of 32 items
(so that a launch repeats bitwise), the forward through ``bounce<true>`` and
``start_path`` of ``csrc/step_math.cuh``, so its decisions are the forward
kernel's, and its partials in shared memory ``[k][thread]``, reduced per
block in a fixed order to ``[blocks, 4N+14]`` rows that the wrapper sums in
float64.  Each bounce stores its input ray, hit id and tie count (8 words,
one 32-byte sector) in a scratch record of ``[grid threads][max_depth][8]``
floats in device memory, sized by the grid, not the items (0.27 GB at
depth 100 for the 8-sphere bucket's 84,480 threads on an H100).  A path
that ends on a miss parks and sweeps its record back one bounce in each
sweep phase its warp runs, recomputing each bounce's forward values from
the record (every sphere's root where the hit's tied).  It takes what the
replay kernel takes (``replay_kernel_takes``: float32, uniform jitter,
1..40 spheres).

Stats: ``segments``, ``iters``, ``lanes`` and ``phases`` are those of the
replay kernel (bounce phases; sweep phases are not counted); ``missed``
counts the paths that ended on a miss (the ones swept), ``sweep_bounces``
the bounces their sweeps went back through and ``tied_bounces`` those of
them whose hit sphere's root tied with another sphere's.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...config import RenderConfig
from ...models.camera import get_rays
from ...utils.profiling import annotate
from ..geometry_replay import (
    geometry_grads_from_partials,
    geometry_items,
    n_geometry_partials,
)
from .megakernel import (
    _check,
    _unpack,
    camera_samples_for_items,
    cell_span,
    index_bits,
    launch_params,
    pack_camera,
    pack_scene,
)
from .replay import _check_ct, check_replay_config

# Items per batch of the plain version: its record holds 7 values a bounce
# of every item of a batch.
REFERENCE_CHUNK = 1 << 18
# Zeroed int64 words a launch counts in: segments, iters, sweep bounces,
# phases, missed paths, tied bounces swept.
GEOMETRY_COUNTER_WORDS = 6
# Words of a bounce's record: the input origin and direction, the hit id and
# the tie count.
RECORD_WORDS = 8


def geometry_replay_reference(table, cam, dyn, ct, *, cfg: RenderConfig, n_cells: int,
                              n_items: int, ior: float = 2.0):
    """Plain PyTorch version of ``geometry_replay``: the same arguments, the
    same ``[4N+14]`` partials and stats.  The bounce math runs in the
    table's dtype (``ops/integrator.bounce_step``), so in float32 its
    decisions are the kernel's; the adjoints and the partials run in
    float64, over ``REFERENCE_CHUNK`` items at a time."""
    _check(table, cam, dyn)
    _check_ct(ct, table, n_cells)
    spheres, camera = _unpack(table, cam, ior)
    dt, dev = table.dtype, table.device
    total = torch.zeros(n_geometry_partials(table.shape[0]), dtype=torch.float64, device=dev)
    stats = {"segments": 0, "iters": 0, "missed": 0, "sweep_bounces": 0, "tied_bounces": 0}
    for i0 in range(0, n_items, REFERENCE_CHUNK):
        item = torch.arange(i0, min(i0 + REFERENCE_CHUNK, n_items), dtype=torch.int64,
                            device=dev)
        c_idx, keys, (s, t, u) = camera_samples_for_items(cfg, dyn, n_cells, item, dt)
        o, d = get_rays(camera, s, t, u[:, 2], u[:, 3])
        part, st = geometry_items(spheres, camera, o, d, keys, (s, t, u), ct[c_idx],
                                  max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                                  epsilon=cfg.epsilon, inf=cfg.inf, acc_dtype=torch.float64)
        total += part
        stats["iters"] += st["depth"]
        for k in ("segments", "missed", "sweep_bounces", "tied_bounces"):
            stats[k] += st[k]
    return total, {**stats, "lanes": min(REFERENCE_CHUNK, n_items)}


def geometry_replay(table, cam, dyn, ct, *, cfg: RenderConfig, n_cells: int, n_items: int,
                    ior: float = 2.0):
    """Replay ``n_items`` paths and accumulate their p0, radius and camera
    partials in one kernel launch.

    Args:
      table: [N,17] (pack_scene); cam: [20] (pack_camera); dyn:
        (cell_start, sample_start) as ints; ct: [n_cells, 3] cotangent of
        the span's per-cell radiance sums (item = sample * n_cells + c takes
        ``ct[c]``).
    Returns (partials [4N+14] in the layout of ``ops/geometry_replay.py``,
    stats), float64.  On CUDA the partials are the float64 sum of the
    blocks' float32 rows and the counts are 0-d int64 device tensors.

    On CUDA tensors this launches the kernel (float32, contiguous,
    N <= MAX_REPLAY_SPHERES, uniform jitter) or raises; on CPU tensors it
    runs the plain version.  ``geometry_replay.launches`` counts the
    launches.
    """
    _check(table, cam, dyn)
    _check_ct(ct, table, n_cells)
    if table.device.type == "cpu":
        return geometry_replay_reference(table, cam, dyn, ct, cfg=cfg, n_cells=n_cells,
                                         n_items=n_items, ior=ior)
    n = table.shape[0]
    check_replay_config(cfg, table.dtype, n)
    if table.device.type != "cuda":
        raise ValueError(f"geometry_replay runs on CUDA or the CPU, not {table.device}")
    if not (table.is_contiguous() and cam.is_contiguous() and ct.is_contiguous()):
        raise ValueError("table, cam and ct must be contiguous")
    if n_cells < 1 or n_items < 0:
        raise ValueError(f"bad item range: n_cells={n_cells}, n_items={n_items}")

    lib = _build.load()
    params = launch_params(cfg, dyn, n_spheres=n, n_cells=n_cells, n_items=n_items, ior=ior)
    m = n_geometry_partials(n)
    counters = torch.zeros(GEOMETRY_COUNTER_WORDS, dtype=torch.int64, device=table.device)
    blocks, threads = ctypes.c_longlong(0), ctypes.c_int(0)
    bits = index_bits(params)
    with torch.cuda.device(table.device):
        err = lib.pt_geometry_grid(n, ctypes.c_longlong(n_items), bits, ctypes.byref(blocks),
                                   ctypes.byref(threads))
        if err != 0:
            raise RuntimeError(f"geometry_replay grid query failed: "
                               f"{lib.pt_error_string(err).decode()} ({err})")
        rows = torch.zeros((max(blocks.value, 1), m), dtype=torch.float32, device=table.device)
        if n_items:
            # Written before it is read; torch's caching allocator hands the
            # same block back to the next launch of this size, 512-byte
            # aligned (the kernel needs 32).
            rec = torch.empty(max(cfg.max_depth, 1) * RECORD_WORDS * blocks.value * threads.value,
                              dtype=torch.float32, device=table.device)
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.pt_geometry_replay(table.data_ptr(), cam.data_ptr(), ct.data_ptr(),
                                         rows.data_ptr(), rec.data_ptr(), counters.data_ptr(),
                                         ctypes.addressof(params), bits, blocks.value, stream)
            if err != 0:
                raise RuntimeError(f"geometry_replay launch failed: "
                                   f"{lib.pt_error_string(err).decode()} ({err})")
            geometry_replay.launches += 1
    return rows.sum(dim=0, dtype=torch.float64), {
        "segments": counters[0], "iters": counters[1], "lanes": blocks.value * threads.value,
        "phases": counters[3], "missed": counters[4], "sweep_bounces": counters[2],
        "tied_bounces": counters[5]}


geometry_replay.launches = 0


def geometry_param_grads_kernel(scene, cfg: RenderConfig, cell_ids, sample_start: int,
                                num_samples: int, ct, *, camera: bool = True):
    """Gradients of ``sum(ct * render_cells_range(scene, cfg, cell_ids,
    sample_start, num_samples))`` with respect to p0, radius and, with
    ``camera``, the camera (a ``CameraConfig`` of its eight leaves), by one
    ``geometry_replay`` call over the span's items.  ``cell_ids`` is a
    contiguous ascending span: a host ``range``, or an id tensor, which alone
    is read back from its device (``megakernel.cell_span``); ``ct`` [B,3].
    Returns the gradients in the scene's dtype."""
    with annotate("pt.k7"):
        cell_start, n_cells = cell_span(cell_ids)
        dyn = (cell_start, int(sample_start))
        dt = scene.dtype
        part, _ = geometry_replay(pack_scene(scene, dt), pack_camera(scene, dt), dyn,
                                  ct.to(dt).contiguous(), cfg=cfg, n_cells=n_cells,
                                  n_items=n_cells * num_samples, ior=scene.ior)
        with annotate("pt.k7.map"):
            return geometry_grads_from_partials(scene, part, camera)
