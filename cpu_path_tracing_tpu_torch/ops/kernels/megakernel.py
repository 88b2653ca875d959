"""The forward render kernel: wrapper, plain version and host format.

``persistent_render`` replaces the TPU kernel
``cpu_path_tracing_tpu/ops/pallas/megakernel.py::persistent_render`` (the
whole wavefront render in one ``pallas_call``) with a CUDA C++ kernel for
Hopper, ``csrc/megakernel.cu`` around the per-path step math of
``csrc/step_math.cuh``.

What bounds it on an H100: FP32 and integer ALU work and warp divergence,
not bytes.  Each path segment costs an N-sphere quadratic, two 13-round
Threefry blocks and the shading, while the only device-memory traffic is
12 bytes written per item.  The design answers divergence by regenerating
in place: a persistent grid of threads each owns one live path, and a
thread whose path ends starts its next item in the same loop trip, so the
warp stays in the bounce code together (the TPU kernel's regenerating lane
pool).  Finished paths write ``out[:, item]`` directly; the TPU kernel's
result ring, watermark and DMA existed only because TPU scatter is slow.

Stats (``segments``, ``iters``, ``lanes``): ``segments`` counts path
segments (live paths summed over bounces, an int64 count), ``lanes`` the
threads launched and ``iters`` the most bounce-loop trips of one thread,
so ``segments / (iters * lanes)`` is an occupancy: the share of thread
trips that did work.  The plain version runs all items as one batch per
chunk: its ``lanes`` is the chunk width and ``iters`` the bounce steps run.

``pack_scene`` / ``pack_camera`` are the host-to-kernel format of the JAX
package, verbatim: an [N,17] sphere table and a [20] camera vector.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ... import _build
from ...config import RenderConfig
from ...models.camera import Camera, build_camera, get_rays
from .. import rng as rng_ops
from ..integrator import radiance

TABLE_COLS = 17
CAM_LEN = 20
# Shared memory the kernel may use without an opt-in: table + camera.
SMEM_BUDGET = 48 * 1024
MAX_SPHERES = (SMEM_BUDGET // 4 - CAM_LEN) // TABLE_COLS
# Items per batch of the plain version: bounds its memory on a full image.
REFERENCE_CHUNK = 1 << 22


def pack_scene(scene, dtype=torch.float32) -> torch.Tensor:
    """Scene -> [N,17] table: p0(3) anchor_dir(3) radius(1) | center(3)
    emission(3) albedo(3) material code(1).  Columns 0..6 feed the
    intersect, 7..16 are read for the hit sphere.  The kernel takes
    float32; the plain version also takes the scene's float64."""
    p0 = scene.p0.to(dtype)
    rad = scene.radius.to(dtype)
    ad = scene.anchor_dir.to(dtype)
    center = p0 - rad[:, None] * ad  # the chain of ops/intersect.py sphere_props
    return torch.cat([p0, ad, rad[:, None], center, scene.emission.to(dtype),
                      scene.albedo.to(dtype), scene.material.to(dtype)[:, None]], dim=1)


def pack_camera(scene, dtype=torch.float32) -> torch.Tensor:
    """Camera frame + background -> [20]: position(3) lower_left(3) cam_x(3)
    cam_y(3) lens_radius(1) bg_bottom(3) bg_top(3) origin_advance(1)."""
    cam = build_camera(scene.camera)
    return torch.cat([cam.position.to(dtype), cam.lower_left.to(dtype), cam.cam_x.to(dtype),
                      cam.cam_y.to(dtype), cam.lens_radius.to(dtype).reshape(1),
                      scene.background.to(dtype).reshape(6),
                      cam.origin_advance.to(dtype).reshape(1)])


class PackedScene(NamedTuple):
    """The sphere fields of a scene, read back from the packed table and
    camera vector (what ops/integrator.bounce_step needs)."""

    p0: torch.Tensor
    radius: torch.Tensor
    anchor_dir: torch.Tensor
    emission: torch.Tensor
    albedo: torch.Tensor
    material: torch.Tensor
    background: torch.Tensor
    ior: float


def _unpack(table: torch.Tensor, cam: torch.Tensor, ior: float):
    spheres = PackedScene(p0=table[:, 0:3], radius=table[:, 6], anchor_dir=table[:, 3:6],
                          emission=table[:, 10:13], albedo=table[:, 13:16],
                          material=table[:, 16].round().long(),
                          background=cam[13:19].reshape(2, 3), ior=ior)
    camera = Camera(position=cam[0:3], lower_left=cam[3:6], cam_x=cam[6:9], cam_y=cam[9:12],
                    lens_radius=cam[12], origin_advance=cam[19])
    return spheres, camera


def _check(table, cam, dyn):
    if table.dim() != 2 or table.shape[1] != TABLE_COLS or tuple(cam.shape) != (CAM_LEN,):
        raise ValueError(f"expected table [N,{TABLE_COLS}] and cam [{CAM_LEN}], got "
                         f"{tuple(table.shape)} and {tuple(cam.shape)}")
    if table.device != cam.device or table.dtype != cam.dtype:
        raise ValueError("table and cam must share one device and dtype")
    if len(dyn) != 2:
        raise ValueError("dyn is (cell_start, sample_start)")


def check_kernel_config(cfg: RenderConfig, dtype: torch.dtype) -> None:
    """Raise ValueError for a render the CUDA kernel does not do.  It is
    float32 with uniform jitter; a CUDA render in float64 or with tent
    jitter raises rather than falling back to the plain path."""
    todo = "(ROADMAP.md Queue 1 item 6: float64 and tent jitter on CUDA)"
    if dtype != torch.float32:
        raise ValueError(f"a {dtype} render on CUDA is not ported yet; the CUDA kernel "
                         f"is float32 {todo}")
    if cfg.jitter != "uniform":
        raise ValueError(f"jitter={cfg.jitter!r} on CUDA is not ported yet; the CUDA "
                         f"kernel has uniform jitter {todo}")


def item_rays(cfg: RenderConfig, camera: Camera, dyn, n_cells: int, i0: int, i1: int,
              dtype, device):
    """The regeneration of items [i0, i1) of a launch, as the kernels do it:
    item = sample * n_cells + c, cell = min(cell_start + c, cells - 1).
    Returns (c [B], item keys (a0, a1), origins [B,3], directions [B,3])."""
    from ...render import screen_coords  # render imports this module

    cell_start, sample_start = (int(v) for v in dyn)
    item = torch.arange(i0, i1, dtype=torch.int64, device=device)
    c_idx = item % n_cells
    cell = torch.clamp(cell_start + c_idx, max=cfg.num_cells - 1)
    a0, a1 = rng_ops.item_keys(cfg.seed, cell, sample_start + item // n_cells)
    u = rng_ops.camera_uniforms(a0, a1).to(dtype)
    s, t = screen_coords(cfg, cell, u, dtype)
    o, d = get_rays(camera, s, t, u[:, 2], u[:, 3])
    return c_idx, (a0, a1), o, d


def persistent_render_reference(table, cam, dyn, *, cfg: RenderConfig, n_cells: int,
                                n_items: int, ior: float = 2.0):
    """Plain PyTorch version of ``persistent_render``: the same arguments,
    the same per-item radiance ``[3, n_items]`` (item = sample * n_cells +
    c, cell = min(cell_start + c, cells - 1)) and stats.  A batched bounce
    loop over the items, ``REFERENCE_CHUNK`` at a time, in the table's dtype
    (float32 or float64); also renders ``cfg.jitter='tent'``."""
    _check(table, cam, dyn)
    spheres, camera = _unpack(table, cam, ior)
    dt, dev = table.dtype, table.device
    out = torch.empty((3, n_items), dtype=dt, device=dev)
    segments = iters = 0
    chunk = REFERENCE_CHUNK
    for i0 in range(0, n_items, chunk):
        i1 = min(i0 + chunk, n_items)
        _, keys, o, d = item_rays(cfg, camera, dyn, n_cells, i0, i1, dt, dev)
        rad, st = radiance(spheres, o, d, keys, max_depth=cfg.max_depth,
                           rr_depth=cfg.rr_depth, epsilon=cfg.epsilon, inf=cfg.inf,
                           with_stats=True)
        out[:, i0:i1] = rad.T
        segments += st["segments"]
        iters += st["depth"]
    return out, {"segments": segments, "iters": iters, "lanes": min(chunk, n_items)}


class _Params(ctypes.Structure):
    """Mirror of ``pt::Params`` in csrc/step_math.cuh."""

    _fields_ = [
        ("n_items", ctypes.c_longlong), ("n_cells", ctypes.c_longlong),
        ("total_cells", ctypes.c_longlong), ("cell_start", ctypes.c_longlong),
        ("sample_start", ctypes.c_longlong), ("n_spheres", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int), ("ns", ctypes.c_int),
        ("max_depth", ctypes.c_int), ("rr_depth", ctypes.c_int),
        ("key0", ctypes.c_uint), ("key1", ctypes.c_uint),
        ("sub_len", ctypes.c_float), ("inv_w", ctypes.c_float), ("inv_h", ctypes.c_float),
        ("eps", ctypes.c_float), ("inf", ctypes.c_float),
        ("ratio_front", ctypes.c_float), ("ratio_back", ctypes.c_float),
    ]


def launch_params(cfg: RenderConfig, dyn, *, n_spheres: int, n_cells: int, n_items: int,
                  ior: float) -> _Params:
    """The ``pt::Params`` of a launch over items [0, n_items) of the span."""
    cell_start, sample_start = (int(v) for v in dyn)
    key0, key1 = rng_ops.master_key(cfg.seed)
    return _Params(
        n_items=n_items, n_cells=n_cells, total_cells=cfg.num_cells, cell_start=cell_start,
        sample_start=sample_start, n_spheres=n_spheres, width=cfg.width, height=cfg.height,
        ns=cfg.num_subpixels, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
        key0=key0, key1=key1, sub_len=1.0 / cfg.num_subpixels, inv_w=1.0 / cfg.width,
        inv_h=1.0 / cfg.height, eps=cfg.epsilon, inf=cfg.inf,
        ratio_front=float(np.float32(1.0 / ior)), ratio_back=float(np.float32(ior)))


def persistent_render(table, cam, dyn, *, cfg: RenderConfig, n_cells: int, n_items: int,
                      ior: float = 2.0):
    """Render ``n_items`` paths in one kernel launch.

    Args:
      table: [N,17] (pack_scene); cam: [20] (pack_camera); dyn:
        (cell_start, sample_start) as ints.
    Returns (out [3, n_items], {"segments", "iters", "lanes"}); on CUDA
    ``segments`` and ``iters`` are 0-d int64 device tensors.

    On CUDA tensors this launches the kernel (float32, contiguous,
    N <= MAX_SPHERES, uniform jitter) or raises.  On CPU tensors it runs
    the plain version.  ``persistent_render.launches`` counts the launches.
    """
    _check(table, cam, dyn)
    if table.device.type == "cpu":
        return persistent_render_reference(table, cam, dyn, cfg=cfg, n_cells=n_cells,
                                           n_items=n_items, ior=ior)
    if table.device.type != "cuda":
        raise ValueError(f"persistent_render runs on CUDA or the CPU, not {table.device}")
    check_kernel_config(cfg, table.dtype)
    if not (table.is_contiguous() and cam.is_contiguous()):
        raise ValueError("table and cam must be contiguous")
    n = table.shape[0]
    if not 1 <= n <= MAX_SPHERES:
        raise ValueError(f"the CUDA kernel holds 1..{MAX_SPHERES} spheres in shared "
                         f"memory ({SMEM_BUDGET} bytes), got {n}")
    if n_cells < 1 or n_items < 0:
        raise ValueError(f"bad item range: n_cells={n_cells}, n_items={n_items}")

    lib = _build.load()
    params = launch_params(cfg, dyn, n_spheres=n, n_cells=n_cells, n_items=n_items, ior=ior)
    out = torch.empty((3, n_items), dtype=torch.float32, device=table.device)
    counters = torch.zeros(2, dtype=torch.int64, device=table.device)
    lanes = ctypes.c_longlong(0)
    if n_items:
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.pt_persistent_render(table.data_ptr(), cam.data_ptr(), out.data_ptr(),
                                           counters.data_ptr(), ctypes.addressof(params),
                                           ctypes.byref(lanes), stream)
        if err != 0:
            raise RuntimeError(f"persistent_render launch failed: "
                               f"{lib.pt_error_string(err).decode()} ({err})")
        persistent_render.launches += 1
    # Device-side counts as 0-d tensors: reading them is the caller's sync.
    return out, {"segments": counters[0], "iters": counters[1], "lanes": lanes.value}


persistent_render.launches = 0
