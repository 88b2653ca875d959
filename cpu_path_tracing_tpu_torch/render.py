"""Rendering pipeline: cells, samples, launches, image.

Counterpart of ``cpu_path_tracing_tpu/render.py``.  The image is a flat
array of subpixel cells, ``cell = (y*W + x) * ns^2 + sy*ns + sx`` with y=0
the bottom row (the reference's vertical flip, ``src/main.cpp:181``,
happens in ``finalize_image``).  Every launch renders a contiguous cell span
for a range of samples (``ops/wavefront.py``); the image is a pure function
of (scene, config, seed), independent of chunking.

The renderer works where the scene lives: ``scene.to("cuda")`` renders
with the CUDA kernels (float32, uniform jitter) or the plain wavefront
loop on the card (float64, tent jitter), a scene on the CPU with the plain
PyTorch versions (``resolve_integrator``).
"""

from __future__ import annotations

import torch

from .config import RenderConfig
from .models.camera import build_camera, get_rays
from .ops import rng as rng_ops
from .ops.integrator import radiance, radiance_compact
from .ops.kernels.megakernel import cell_ids_of, check_kernel_config
from .ops.wavefront import (
    render_wavefront,
    render_wavefront_per_step,
    render_wavefront_persistent,
)
from .utils import debug
from .utils.profiling import annotate


def decode_cells(cell_ids, cfg: RenderConfig):
    """cell id -> (x, y, sx, sy) integer tensors."""
    ns = cfg.num_subpixels
    sub = cell_ids % (ns * ns)
    pix = cell_ids // (ns * ns)
    return pix % cfg.width, pix // cfg.width, sub % ns, sub // ns


def screen_coords(cfg: RenderConfig, cell_ids, u4, dtype):
    """Jittered screen coordinates (s, t) in [0,1) of cells from a [B,4]
    camera-uniform block (``src/main.cpp:186-190``; or smallpt's tent
    filter, ``sandbox/main.cpp:253-256``, with ``cfg.jitter='tent'``)."""
    ns = cfg.num_subpixels
    x, y, sx, sy = decode_cells(cell_ids, cfg)
    sub_len = 1.0 / ns
    if cfg.jitter == "tent":
        def tent(u):
            r = 2.0 * u
            return torch.where(r < 1.0, torch.sqrt(r) - 1.0, 1.0 - torch.sqrt(2.0 - r))

        jx, jy = 0.5 + tent(u4[:, 0]), 0.5 + tent(u4[:, 1])
    elif cfg.jitter == "uniform":
        jx, jy = u4[:, 0], u4[:, 1]
    else:
        raise ValueError(f"unknown jitter {cfg.jitter!r}")
    x_in = x.to(dtype) + sx.to(dtype) * sub_len + jx * sub_len
    y_in = y.to(dtype) + sy.to(dtype) * sub_len + jy * sub_len
    # Multiply by the reciprocal constant, as the kernel does.
    return x_in * (1.0 / cfg.width), y_in * (1.0 / cfg.height)


def camera_rays_for_cells(scene, cfg: RenderConfig, cell_ids, u4, dtype):
    """Thin-lens rays (origins [B,3], directions [B,3]) for cells from a
    [B,4] camera-uniform block."""
    s, t = screen_coords(cfg, cell_ids, u4, dtype)
    return get_rays(build_camera(scene.camera), s, t, u4[:, 2], u4[:, 3])


def camera_rays(scene, cfg: RenderConfig, cell_ids, sample_idx: int, dtype):
    """Per-(cell, sample) item keys and jittered thin-lens rays: ((a0, a1),
    origins [B,3], directions [B,3])."""
    a0, a1 = rng_ops.item_keys(cfg.seed, cell_ids, sample_idx)
    u = rng_ops.camera_uniforms(a0, a1).to(dtype)
    o, d = camera_rays_for_cells(scene, cfg, cell_ids, u, dtype)
    return (a0, a1), o, d


def _on_cuda(scene) -> bool:
    return scene.device.type == "cuda"


def resolve_integrator(scene, cfg: RenderConfig) -> str:
    """The route of a render, picked from the config before anything
    launches (JAX ``render.py:107-119``):

    * 'batch', one batch of the cells per sample through
      ``ops/integrator.radiance`` (differentiable, any cell-id set):
      ``cfg.integrator='batch'``, or ``loop='scan'`` with any integrator.
    * 'pallas', the CUDA kernels: ``cfg.integrator='pallas'``, or 'auto' on
      a CUDA scene in float32 with uniform jitter.  It raises ValueError
      for float64 or tent jitter (``check_kernel_config``), as the JAX
      package does, instead of falling back.
    * 'wavefront', the plain wavefront loop: ``cfg.integrator='wavefront'``,
      or 'auto' on a CUDA scene the kernels do not render.
    * 'plain': 'auto' on the CPU, the plain version of the whole-render
      kernel in the scene's dtype and jitter."""
    if cfg.loop not in ("while", "scan"):
        raise ValueError(f"unknown loop {cfg.loop!r}: 'while' or 'scan'")
    integ = cfg.integrator
    if integ not in ("auto", "wavefront", "pallas", "batch"):
        raise ValueError(f"unknown integrator {integ!r}: 'auto', 'wavefront', 'pallas' or "
                         "'batch'")
    if integ == "batch" or cfg.loop == "scan":
        return "batch"
    if integ == "auto":
        if not _on_cuda(scene):
            return "plain"
        kernel = scene.dtype == torch.float32 and cfg.jitter == "uniform"
        integ = "pallas" if kernel else "wavefront"
    if integ == "pallas":
        check_kernel_config(cfg, scene.dtype)
    return integ


def render_batch(scene, cfg: RenderConfig, cell_ids, sample_start: int, num_samples: int):
    """The 'batch' route (JAX ``render.py:152-179``): per sample, the rays of
    every cell in ``cell_ids`` (any id set) through ``radiance`` with
    ``cfg.loop`` and ``cfg.remat``, or through ``radiance_compact`` when
    ``cfg.compact_schedule`` is set; the samples summed in order.  A host
    ``range`` becomes a ``torch.arange`` on the scene's device.  [B,3]."""
    cell_ids = cell_ids_of(cell_ids, scene.device)
    kw = dict(max_depth=cfg.max_depth, rr_depth=cfg.rr_depth, epsilon=cfg.epsilon,
              inf=cfg.inf, loop=cfg.loop, remat=cfg.remat)
    acc = None
    for i in range(num_samples):
        keys, o, d = camera_rays(scene, cfg, cell_ids, sample_start + i, scene.dtype)
        if cfg.compact_schedule is not None:
            out = radiance_compact(scene, o, d, keys, schedule=cfg.compact_schedule, **kw)
        else:
            out = radiance(scene, o, d, keys, **kw)
        acc = out if acc is None else acc + out
    return acc if acc is not None else torch.zeros((cell_ids.shape[0], 3), dtype=scene.dtype,
                                                   device=scene.device)


def render_cells_range(scene, cfg: RenderConfig, cell_ids, sample_start: int,
                       num_samples: int, *, with_stats: bool = False):
    """SUM of radiance over samples [sample_start, sample_start+num_samples)
    for each cell: [B,3], unclamped, unnormalized (plus the launch's stats
    with ``with_stats``, which the batch route does not keep).  Any
    partition of the sample range sums to the same total up to float
    association.  ``cell_ids`` is an id tensor or a host ``range``.
    Dispatch as JAX ``render.py:135-150``: 'batch' -> ``render_batch`` (any
    id set); every other route takes a contiguous ascending span, whose
    start it reads from a range on the host and from a tensor alone by a
    read-back from its device (``ops/kernels/megakernel.cell_span``);
    'wavefront' -> ``render_wavefront``; 'pallas' -> the
    whole-render kernel, or with ``cfg.pallas_persistent=False`` the
    per-step kernel; 'plain' -> the whole-render kernel's wrapper, which
    runs its plain version for a scene on the CPU.  Inside
    ``utils/debug.debug_context`` the sums are checked for NaN
    (``FloatingPointError``)."""
    integ = resolve_integrator(scene, cfg)
    args = (scene, cfg, cell_ids, sample_start, num_samples)
    if integ == "batch":
        if with_stats:
            raise ValueError("the batch route keeps no launch stats")
        out = render_batch(*args)
    elif integ == "wavefront":
        out = render_wavefront(*args, with_stats=with_stats)
    elif integ == "pallas" and not cfg.pallas_persistent:
        out = render_wavefront_per_step(*args, with_stats=with_stats)
    else:
        out = render_wavefront_persistent(*args, with_stats=with_stats)
    debug.guard(out[0] if with_stats else out, "render_cells_range")
    return out


def render_cells(scene, cfg: RenderConfig, cell_ids) -> torch.Tensor:
    """Mean radiance over cfg.spp samples for each cell.  [B,3], unclamped."""
    return render_cells_range(scene, cfg, cell_ids, 0, cfg.spp) / cfg.spp


def sample_chunk_for(spp: int, num_cells: int, items_cap: int = 64 << 20) -> int:
    """Largest divisor of spp keeping num_cells*chunk items per launch under
    the cap (the item output is 12 bytes per item in float32)."""
    cap = max(1, items_cap // max(1, num_cells))
    return max(c for c in range(1, min(spp, cap) + 1) if spp % c == 0)


def finalize_image(cell_means: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Cell means [num_cells,3] -> linear image [H,W,3], top row first.
    Each subpixel is clamped to [0,1] before the subpixels are averaged
    (the reference's bias, ``src/main.cpp:195-196``)."""
    ns2 = cfg.num_subpixels * cfg.num_subpixels
    c = torch.clamp(cell_means, 0.0, 1.0)
    pixels = c.reshape(cfg.height, cfg.width, ns2, 3).mean(dim=2)
    return torch.flip(pixels, dims=(0,))  # y=0 is the bottom row


def render_image(scene, cfg: RenderConfig) -> torch.Tensor:
    """Render the full image on the scene's device: linear radiance
    [H,W,3].  Cells are chunked by ``cfg.ray_chunk`` (whole pixels per
    chunk); samples are chunked only above ``sample_chunk_for``'s item cap."""
    with annotate("pt.render_image"):
        n = cfg.num_cells
        ns2 = cfg.num_subpixels * cfg.num_subpixels
        chunk = cfg.ray_chunk or n
        chunk = max(ns2, chunk - chunk % ns2)
        outs = []
        for start in range(0, n, chunk):
            with annotate("pt.render.setup"):
                ids = range(start, min(start + chunk, n))
                schunk = sample_chunk_for(cfg.spp, len(ids))
            if schunk == cfg.spp:
                outs.append(render_cells(scene, cfg, ids))
                continue
            acc = render_cells_range(scene, cfg, ids, 0, schunk)
            for s0 in range(schunk, cfg.spp, schunk):
                acc = acc + render_cells_range(scene, cfg, ids, s0, schunk)
            outs.append(acc / cfg.spp)
        with annotate("pt.render.finalize"):
            return finalize_image(torch.cat(outs, dim=0), cfg)
