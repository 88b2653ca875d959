"""The replay backward kernel: wrapper, plain version and gradient entry.

``replay_persistent`` replaces the TPU kernel
``cpu_path_tracing_tpu/ops/pallas/replay_kernel.py::replay_persistent``
(the whole analytic backward of albedo, emission and background in one
``pallas_call``) with a CUDA C++ kernel for Hopper, ``csrc/replay.cu``,
around the forward kernel's step math (``csrc/step_math.cuh``,
``bounce<true>`` with its aux outputs).

What bounds it on an H100: the forward kernel's FP32 and integer ALU work
and divergence; the accumulation beside it is a few per cent, but its
``7N+6`` per-thread partials in registers held the first design to 12
resident warps an SM.  The design keeps the forward's loop (a persistent
grid, one live path per thread, a refill phase the warp's idle lanes enter
together) over warp-owned chunks of items, and moves the partials to shared memory,
``[k][thread]``; only the ``2N`` prefix counters stay in registers, and a
bounce adds only to the spheres whose counter is not zero.  A refilling
lane reads its path's cotangent ``ct[item % n_cells]`` (3 floats) straight
from device memory, where the TPU kernel needed a K-slot ring because TPU
gathers are slow.  Gradients are reduced deterministically: which lane
replays an item is fixed by the launch, each block sums its threads'
partials in a fixed order and writes one row of a ``[blocks, 7N+6]``
buffer, which the wrapper sums with plain torch, so two launches on the
same inputs give bitwise-equal gradients.

Stats (``segments``, ``iters``, ``lanes``, ``phases``) are those of the
forward kernel (``ops/kernels/megakernel.py``); here all of them repeat from
launch to launch, since a warp's items are fixed by the launch.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build
from ...config import RenderConfig
from ...utils.profiling import annotate
from ..replay import grads_from_partials, n_partials, replay_items
from .megakernel import (
    COUNTER_WORDS,
    REFERENCE_CHUNK,
    _check,
    _unpack,
    cell_span,
    check_kernel_config,
    index_bits,
    item_rays,
    launch_params,
    pack_camera,
    pack_scene,
)

# The per-thread counters and the rows of the partials in shared memory are
# sized by a compile-time bucket of the sphere count (csrc/replay.cu: 8, 16,
# 40); the largest bucket is the JAX
# package's VMEM-budget limit, kept so that both packages take the same
# scenes (cpu_path_tracing_tpu/ops/pallas/replay_kernel.py:68).
MAX_REPLAY_SPHERES = 40


def replay_kernel_takes(cfg: RenderConfig, dtype: torch.dtype, n_spheres: int) -> bool:
    """Whether the CUDA replay kernel takes this replay: float32, uniform
    jitter and 1..MAX_REPLAY_SPHERES spheres (``check_replay_config``)."""
    return (dtype == torch.float32 and cfg.jitter == "uniform"
            and 1 <= n_spheres <= MAX_REPLAY_SPHERES)


def check_replay_config(cfg: RenderConfig, dtype: torch.dtype, n_spheres: int) -> None:
    """Raise ValueError for a replay the CUDA kernel does not do: the forward
    kernel's rule (float32, uniform jitter) and at most MAX_REPLAY_SPHERES
    spheres.  ``ops/replay.replay_param_grads_auto`` sends such a scene to
    the plain replay on the card before anything launches; the kernel's
    wrapper itself raises rather than run the plain version."""
    check_kernel_config(cfg, dtype)
    if not 1 <= n_spheres <= MAX_REPLAY_SPHERES:
        raise ValueError(
            f"the CUDA replay kernel holds 1..{MAX_REPLAY_SPHERES} spheres, got {n_spheres}; "
            "ops/replay.replay_param_grads_auto takes a larger scene to the plain replay")


def _check_ct(ct, table, n_cells: int) -> None:
    if tuple(ct.shape) != (n_cells, 3):
        raise ValueError(f"ct must be [n_cells, 3] = [{n_cells}, 3], got {tuple(ct.shape)}")
    if ct.device != table.device or ct.dtype != table.dtype:
        raise ValueError("ct must share the table's device and dtype")


def replay_persistent_reference(table, cam, dyn, ct, *, cfg: RenderConfig, n_cells: int,
                                n_items: int, ior: float = 2.0):
    """Plain PyTorch version of ``replay_persistent``: the same arguments,
    the same ``[7N+6]`` partials and stats, and ``prefix_terms`` (the
    non-zero ``cnt * q`` terms, ``ops/replay.replay_items``: what the bound
    charges the accumulation).  The bounce math runs in the
    table's dtype (``ops/integrator.bounce_step``), so in float32 its
    decisions are the kernel's; the partials accumulate in float64, over
    ``REFERENCE_CHUNK`` items at a time."""
    _check(table, cam, dyn)
    _check_ct(ct, table, n_cells)
    spheres, camera = _unpack(table, cam, ior)
    dt, dev = table.dtype, table.device
    total = torch.zeros(n_partials(table.shape[0]), dtype=torch.float64, device=dev)
    segments = iters = prefix_terms = 0
    for i0 in range(0, n_items, REFERENCE_CHUNK):
        i1 = min(i0 + REFERENCE_CHUNK, n_items)
        c_idx, keys, o, d = item_rays(cfg, camera, dyn, n_cells, i0, i1, dt, dev)
        part, st = replay_items(spheres, o, d, keys, ct[c_idx], max_depth=cfg.max_depth,
                                rr_depth=cfg.rr_depth, epsilon=cfg.epsilon, inf=cfg.inf,
                                acc_dtype=torch.float64)
        total += part
        segments += st["segments"]
        iters += st["depth"]
        prefix_terms += st["prefix_terms"]
    return total, {"segments": segments, "iters": iters, "lanes": min(REFERENCE_CHUNK, n_items),
                   "prefix_terms": prefix_terms}


def replay_persistent(table, cam, dyn, ct, *, cfg: RenderConfig, n_cells: int, n_items: int,
                      ior: float = 2.0):
    """Replay ``n_items`` paths and accumulate their gradient partials in one
    kernel launch.

    Args:
      table: [N,17] (pack_scene); cam: [20] (pack_camera); dyn:
        (cell_start, sample_start) as ints; ct: [n_cells, 3] cotangent of
        the span's per-cell radiance sums (item = sample * n_cells + c takes
        ``ct[c]``).
    Returns (partials [7N+6] in the layout of ``ops/replay.py``,
    {"segments", "iters", "lanes"}), float64.  On CUDA they are the float64
    sum of the blocks' float32 rows, and ``segments`` and ``iters`` are 0-d
    int64 device tensors.

    On CUDA tensors this launches the kernel (float32, contiguous,
    N <= MAX_REPLAY_SPHERES, uniform jitter) or raises.  On CPU tensors it
    runs the plain version.  ``replay_persistent.launches`` counts the
    launches.
    """
    _check(table, cam, dyn)
    _check_ct(ct, table, n_cells)
    if table.device.type == "cpu":
        return replay_persistent_reference(table, cam, dyn, ct, cfg=cfg, n_cells=n_cells,
                                           n_items=n_items, ior=ior)
    n = table.shape[0]
    check_replay_config(cfg, table.dtype, n)
    if table.device.type != "cuda":
        raise ValueError(f"replay_persistent runs on CUDA or the CPU, not {table.device}")
    if not (table.is_contiguous() and cam.is_contiguous() and ct.is_contiguous()):
        raise ValueError("table, cam and ct must be contiguous")
    if n_cells < 1 or n_items < 0:
        raise ValueError(f"bad item range: n_cells={n_cells}, n_items={n_items}")

    lib = _build.load()
    params = launch_params(cfg, dyn, n_spheres=n, n_cells=n_cells, n_items=n_items, ior=ior)
    m = n_partials(n)
    counters = torch.zeros(COUNTER_WORDS, dtype=torch.int64, device=table.device)
    blocks, threads = ctypes.c_longlong(0), ctypes.c_int(0)
    bits = index_bits(params)
    with torch.cuda.device(table.device):
        err = lib.pt_replay_grid(n, ctypes.c_longlong(n_items), bits, ctypes.byref(blocks),
                                 ctypes.byref(threads))
        if err != 0:
            raise RuntimeError(f"replay_persistent grid query failed: "
                               f"{lib.pt_error_string(err).decode()} ({err})")
        rows = torch.zeros((max(blocks.value, 1), m), dtype=torch.float32, device=table.device)
        if n_items:
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.pt_replay_persistent(table.data_ptr(), cam.data_ptr(), ct.data_ptr(),
                                           rows.data_ptr(), counters.data_ptr(),
                                           ctypes.addressof(params), bits, blocks.value, stream)
            if err != 0:
                raise RuntimeError(f"replay_persistent launch failed: "
                                   f"{lib.pt_error_string(err).decode()} ({err})")
            replay_persistent.launches += 1
    # The sum over blocks is the reduction outside the kernel (the JAX
    # wrapper's jnp.sum over the accumulator block), in float64.
    return rows.sum(dim=0, dtype=torch.float64), {
        "segments": counters[0], "iters": counters[1], "lanes": blocks.value * threads.value,
        "phases": counters[3]}


replay_persistent.launches = 0


def replay_param_grads_kernel(scene, cfg: RenderConfig, cell_ids, sample_start: int,
                              num_samples: int, ct):
    """Gradients of ``sum(ct * render_cells_range(scene, cfg, cell_ids,
    sample_start, num_samples))`` with respect to albedo, emission and
    background, by one ``replay_persistent`` call over the span's items
    (counterpart of ``replay_param_grads_pallas``).  ``cell_ids`` is a
    contiguous ascending span: a host ``range``, or an id tensor, which alone
    is read back from its device (``megakernel.cell_span``); ``ct`` [B,3].
    Returns the gradients in the scene's dtype."""
    with annotate("pt.k3"):
        cell_start, n_cells = cell_span(cell_ids)
        dyn = (cell_start, int(sample_start))
        dt = scene.dtype
        part, _ = replay_persistent(pack_scene(scene, dt), pack_camera(scene, dt), dyn,
                                    ct.to(dt).contiguous(), cfg=cfg, n_cells=n_cells,
                                    n_items=n_cells * num_samples, ior=scene.ior)
        return {k: v.to(dt) for k, v in grads_from_partials(scene.albedo, part).items()}
