"""The forward render kernels: wrappers, plain versions and host format.

``persistent_render`` replaces the TPU kernel
``cpu_path_tracing_tpu/ops/pallas/megakernel.py::persistent_render`` (the
whole wavefront render in one ``pallas_call``) with a CUDA C++ kernel for
Hopper, ``csrc/megakernel.cu`` around the per-path step math of
``csrc/step_math.cuh``.

What bounds it on an H100: FP32 and integer ALU work and warp divergence,
not bytes.  Each path segment costs an N-sphere quadratic, two 13-round
Threefry blocks and the shading, while the only device-memory traffic is
12 bytes written per item.  The design answers divergence in the loop of a
warp: a persistent grid of threads each owns one live path; lanes whose
path ended sit out the bounces until 6 of the warp's 32 are idle, then
start their next items together (the TPU kernel's regenerating lane pool,
refilled in batches), taking them from one queue for the whole launch, so
lanes and warps share the work whatever their path lengths.  Finished
paths write ``out[:, item]`` directly; the TPU kernel's result ring,
watermark and DMA existed only because TPU scatter is slow.  Item indices are 32-bit in the kernel when the span fits
(``index_bits``): this card emulates 64-bit division.

Stats (``segments``, ``iters``, ``lanes``): ``segments`` counts path
segments (live paths summed over bounces, an int64 count), ``lanes`` the
threads launched and ``iters`` the most bounce phases one warp ran (each
its threads' trip through the bounce code, alive or sitting out), so
``segments / (iters * lanes)`` is an occupancy: the share of thread trips
that did work against the warp that ran longest, and with ``phases`` (the
bounce phases summed over warps) ``segments / (32 * phases)`` is the SIMT
efficiency of the bounce.  ``iters`` and ``phases`` belong to the kernel's
schedule (which warp takes which item from the queue), not to the render:
nothing holds them equal to another path's count, or to another launch's.
The plain version runs all items as one batch per chunk: its ``lanes`` is
the chunk width and ``iters`` the bounce steps run.

``pack_scene`` / ``pack_camera`` are the host-to-kernel format of the JAX
package, verbatim: an [N,17] sphere table and a [20] camera vector.

``megakernel_step`` replaces the TPU kernel
``cpu_path_tracing_tpu/ops/pallas/megakernel.py::megakernel_step`` (one
wavefront iteration per ``pallas_call``) with ``csrc/megakernel_step.cu``:
one launch advances every lane of a pool of B lanes by ``steps`` bounces,
the lane state (``LaneState``) living in device memory between launches.
What it adds to the whole-render kernel's arithmetic is that state
traffic, 15 words read and written per live lane per launch, and the
launches themselves.  The design keeps both small: the path stays in
registers for the ``steps`` bounces of a launch, an idle lane with nothing
left to start reads two words and writes none, and a launch does not
depend on which launch it is, so ``megakernel_step_batch`` captures a batch
of launches in a CUDA graph once and the host replays it.  Its plain
version, ``megakernel_step_reference``, is also the step of the plain
wavefront loop (``ops/wavefront.render_wavefront``) in any dtype and jitter.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ... import _build
from ...config import RenderConfig
from ...models.camera import Camera, build_camera, get_rays
from ...utils.profiling import annotate
from .. import rng as rng_ops
from ..integrator import RayState, bounce_step, radiance

TABLE_COLS = 17
CAM_LEN = 20
# The most spheres the render kernels take: the [N,17] table and the camera
# in 48 KB, the bound the first design set itself.  The kernels now hold a
# sphere as a row of 20 floats in shared memory (csrc/step_math.cuh
# load_scene), 57,760 bytes at this count, and ask for what is above 48 KB.
MAX_SPHERES = (48 * 1024 // 4 - CAM_LEN) // TABLE_COLS
# Steps one launch of the per-step kernel may run (a bit per step in its live mask).
MAX_STEPS = 32
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


def cell_span(cells) -> tuple:
    """``(cell_start, n_cells)`` of a contiguous ascending cell span, which
    a launch regenerates as ``cell_start + offset``.

    ``cells`` is a host ``range`` of step 1, as the port's own callers pass
    it: read with no torch call, so nothing waits on the card.  Or an id
    tensor, as a public caller may pass: its contiguity is checked and its
    first id read back from its device (two syncs), under a
    ``pt.cells.readback`` span.  Any other id set raises ValueError instead
    of rendering the wrong cells."""
    if isinstance(cells, range):
        n = len(cells)
        if n > 1 and cells.step != 1:
            raise ValueError(f"render launches need a contiguous ascending cell span "
                             f"(got {cells})")
        return (cells.start if n else 0), n
    with annotate("pt.cells.readback"):
        n = int(cells.shape[0])
        if n > 1 and not bool(torch.all(torch.diff(cells) == 1)):
            raise ValueError("render launches need a contiguous ascending cell_ids span "
                             "(got a non-contiguous id set)")
        return (int(cells[0]) if n else 0), n


def cell_ids_of(cells, device) -> torch.Tensor:
    """The int64 id tensor of ``cells`` on ``device``, for the routes that
    take any id set: a host ``range`` becomes a ``torch.arange`` there (no
    sync), a tensor is returned as it is."""
    if isinstance(cells, range):
        return torch.arange(cells.start, cells.stop, cells.step, dtype=torch.int64,
                            device=device)
    return cells


def check_kernel_config(cfg: RenderConfig, dtype: torch.dtype) -> None:
    """Raise ValueError for a render the CUDA kernels do not do.  They are
    float32 with uniform jitter, as the JAX package's Pallas kernels are;
    ``integrator='wavefront'`` (what 'auto' picks for such a scene) renders
    the rest with the plain wavefront loop.  Nothing falls back after a
    kernel is asked for."""
    todo = ("integrator='wavefront' renders it forward, and "
            "ops/replay.replay_param_grads_auto takes its replay to the plain version")
    if dtype != torch.float32:
        raise ValueError(f"the CUDA kernels are float32, got {dtype}: {todo}")
    if cfg.jitter != "uniform":
        raise ValueError(f"jitter={cfg.jitter!r} is not in the CUDA kernels' camera "
                         f"(uniform jitter): {todo}")


def item_rays(cfg: RenderConfig, camera: Camera, dyn, n_cells: int, i0: int, i1: int,
              dtype, device):
    """The regeneration of items [i0, i1) of a launch, as the kernels do it:
    item = sample * n_cells + c, cell = min(cell_start + c, cells - 1).
    Returns (c [B], item keys (a0, a1), origins [B,3], directions [B,3])."""
    item = torch.arange(i0, i1, dtype=torch.int64, device=device)
    return rays_for_items(cfg, camera, dyn, n_cells, item, dtype)


def rays_for_items(cfg: RenderConfig, camera: Camera, dyn, n_cells: int, item, dtype):
    """``item_rays`` for an int64 tensor of item indices."""
    c_idx, keys, (s, t, u) = camera_samples_for_items(cfg, dyn, n_cells, item, dtype)
    o, d = get_rays(camera, s, t, u[:, 2], u[:, 3])
    return c_idx, keys, o, d


def camera_samples_for_items(cfg: RenderConfig, dyn, n_cells: int, item, dtype):
    """The camera samples of items (an int64 tensor) as the kernels regenerate
    them: (c [B], item keys (a0, a1), (s [B], t [B], camera uniforms [B,4]))."""
    from ...render import screen_coords  # render imports this module

    cell_start, sample_start = (int(v) for v in dyn)
    c_idx = item % n_cells
    cell = torch.clamp(cell_start + c_idx, max=cfg.num_cells - 1)
    a0, a1 = rng_ops.item_keys(cfg.seed, cell, sample_start + item // n_cells)
    u = rng_ops.camera_uniforms(a0, a1).to(dtype)
    s, t = screen_coords(cfg, cell, u, dtype)
    return c_idx, (a0, a1), (s, t, u)


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


def index_bits(params: _Params) -> int:
    """32 when every index the whole-render and replay kernels form for this
    launch is below 2^31 (items, the span's and the image's cells, the last
    sample index), so that they can run on 32-bit arithmetic; else 64."""
    samples = -(-params.n_items // max(params.n_cells, 1))
    most = max(params.n_items, params.cell_start + params.n_cells, params.total_cells,
               params.sample_start + samples)
    return 32 if most < 2 ** 31 else 64


# Zeroed int64 words a launch counts in: segments, iters, the whole-render
# kernel's item queue, phases (measurement builds count further on).
COUNTER_WORDS = 4


def persistent_render(table, cam, dyn, *, cfg: RenderConfig, n_cells: int, n_items: int,
                      ior: float = 2.0):
    """Render ``n_items`` paths in one kernel launch.

    Args:
      table: [N,17] (pack_scene); cam: [20] (pack_camera); dyn:
        (cell_start, sample_start) as ints.
    Returns (out [3, n_items], {"segments", "iters", "lanes"}); on CUDA
    ``segments`` and ``iters`` are 0-d int64 device tensors, and ``phases``
    (the bounce phases summed over warps) is there too.

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
                         f"memory, got {n}")
    if n_cells < 1 or n_items < 0:
        raise ValueError(f"bad item range: n_cells={n_cells}, n_items={n_items}")

    lib = _build.load()
    params = launch_params(cfg, dyn, n_spheres=n, n_cells=n_cells, n_items=n_items, ior=ior)
    out = torch.empty((3, n_items), dtype=torch.float32, device=table.device)
    counters = torch.zeros(COUNTER_WORDS, dtype=torch.int64, device=table.device)
    lanes = ctypes.c_longlong(0)
    if n_items:
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.pt_persistent_render(table.data_ptr(), cam.data_ptr(), out.data_ptr(),
                                           counters.data_ptr(), ctypes.addressof(params),
                                           index_bits(params), ctypes.byref(lanes), stream)
        if err != 0:
            raise RuntimeError(f"persistent_render launch failed: "
                               f"{lib.pt_error_string(err).decode()} ({err})")
        persistent_render.launches += 1
    # Device-side counts as 0-d tensors: reading them is the caller's sync.
    return out, {"segments": counters[0], "iters": counters[1], "lanes": lanes.value,
                 "phases": counters[3]}


persistent_render.launches = 0


# ---- the per-step kernel -------------------------------------------------

# Lane state rows: the fields of pt::Path (csrc/step_math.cuh), then the
# lane's generation (its item is gen * lanes + lane) and alive flag.  k0
# and k1 are uint32 item-key words held as int32 bit patterns.
LANE_F = ("ox", "oy", "oz", "dx", "dy", "dz", "thx", "thy", "thz", "emx", "emy", "emz")
LANE_I = ("depth", "k0", "k1", "gen", "alive")
_DEPTH, _K0, _K1, _GEN, _ALIVE = range(len(LANE_I))


class LaneState(NamedTuple):
    """SoA lane pool of the per-step kernel, one row per field, updated in
    place by each step: ``f`` [12, B] in the render's dtype (float32 for the
    kernel), ``i`` [5, B] int32."""

    f: torch.Tensor
    i: torch.Tensor


def init_lane_state(lanes: int, device, dtype=torch.float32) -> LaneState:
    """A pool of idle lanes that have processed no item (gen = -1)."""
    f = torch.zeros((len(LANE_F), lanes), dtype=dtype, device=device)
    i = torch.zeros((len(LANE_I), lanes), dtype=torch.int32, device=device)
    i[_GEN] = -1
    return LaneState(f, i)


def lane_state_equal(a: LaneState, b: LaneState) -> bool:
    """Whether two pools hold the same state: ``gen`` and ``alive`` of every
    lane and the path of every live lane, bitwise.  An idle lane's path
    rows are read by nothing (they hold what a step last stored there,
    which depends on how many steps a launch ran), so they do not count."""
    if not torch.equal(a.i[_GEN:], b.i[_GEN:]):
        return False
    live = a.i[_ALIVE] != 0
    return torch.equal(a.f[:, live], b.f[:, live]) and torch.equal(a.i[:_GEN, live],
                                                                   b.i[:_GEN, live])


def lane_state_from_arrays(d) -> LaneState:
    """The JAX package's per-step state (its ``STATE_NAMES`` dict of
    [B/128, 128] arrays, as NumPy) in the port's layout, on the CPU.  The
    JAX state's result rows (``rsx`` ...) have no counterpart: the port
    writes a finished path's radiance straight to the output."""
    f = np.stack([np.asarray(d[n]).reshape(-1) for n in LANE_F])
    i = np.stack([np.asarray(d[n]).reshape(-1).view(np.int32) if n in ("k0", "k1")
                  else np.asarray(d[n], np.int32).reshape(-1) for n in LANE_I])
    return LaneState(torch.from_numpy(np.ascontiguousarray(f)),
                     torch.from_numpy(np.ascontiguousarray(i)))


def _check_step(state: LaneState, table, *, n_cells: int, n_items: int, lanes: int, out,
                seg, seg_slot: int, steps: int) -> None:
    if n_cells < 1 or n_items < 1 or lanes < 1:
        raise ValueError(f"bad item range: n_cells={n_cells}, n_items={n_items}, "
                         f"lanes={lanes}")
    if int(steps) != steps or not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"steps must be an integer in 1..{MAX_STEPS}, got {steps!r}")
    if (tuple(state.f.shape) != (len(LANE_F), lanes)
            or tuple(state.i.shape) != (len(LANE_I), lanes)
            or state.i.dtype != torch.int32 or state.f.dtype != table.dtype):
        raise ValueError(f"state must be f [{len(LANE_F)}, {lanes}] in the table's dtype and "
                         f"i [{len(LANE_I)}, {lanes}] int32 (init_lane_state)")
    if tuple(out.shape) != (3, n_items) or out.dtype != table.dtype:
        raise ValueError(f"out must be [3, {n_items}] in the table's dtype")
    if (seg.dim() != 1 or seg.dtype != torch.int64
            or not 0 <= seg_slot <= seg.shape[0] - steps):
        raise ValueError(f"seg must be a 1-d int64 tensor holding slots {seg_slot}.."
                         f"{seg_slot + steps - 1}")
    if any(t.device != table.device for t in (state.f, state.i, out, seg)):
        raise ValueError("state, out and seg must be on the table's device")


def _one_step_reference(state: LaneState, spheres, camera, table, dyn, *, cfg: RenderConfig,
                        n_cells: int, n_items: int, lanes: int, out, seg, seg_slot: int,
                        hist) -> None:
    f, iv = state.f, state.i
    n_gens = -(-n_items // lanes)
    want = iv[_GEN].long() + 1
    can = (iv[_ALIVE] == 0) & (want < n_gens)
    iv[_GEN] = torch.where(can, want, iv[_GEN].long()).to(torch.int32)
    item = want * lanes + torch.arange(lanes, device=table.device)
    new = torch.nonzero(can & (item < n_items)).squeeze(1)
    if new.numel():
        _, (a0, a1), o, d = rays_for_items(cfg, camera, dyn, n_cells, item[new], table.dtype)
        f[:, new] = torch.cat([o.T, d.T, torch.ones_like(o.T), torch.zeros_like(o.T)])
        iv[_DEPTH, new] = 0
        iv[_K0, new], iv[_K1, new] = rng_ops.int32_bits(a0), rng_ops.int32_bits(a1)
        iv[_ALIVE, new] = 1
    lane = torch.nonzero(iv[_ALIVE] != 0).squeeze(1)
    seg[seg_slot] += lane.numel()
    if not lane.numel():
        return
    fl = f[:, lane]
    ray = RayState(origin=fl[0:3].T, direction=fl[3:6].T, throughput=fl[6:9].T,
                   emission=fl[9:12].T, alive=torch.ones_like(lane, dtype=torch.bool),
                   result=torch.zeros_like(fl[0:3].T))
    depth = iv[_DEPTH, lane].long()
    u = rng_ops.bounce_uniforms(rng_ops.words_from_int32(iv[_K0, lane]),
                                rng_ops.words_from_int32(iv[_K1, lane]), depth).to(table.dtype)
    ray = bounce_step(spheres, ray, u, depth, rr_depth=cfg.rr_depth, epsilon=cfg.epsilon,
                      inf=cfg.inf)
    depth = depth + 1
    exhausted = ray.alive & (depth >= cfg.max_depth)  # src/main.cpp:157
    result = torch.where(exhausted[:, None], ray.emission, ray.result)
    alive = ray.alive & ~exhausted
    f[:, lane] = torch.cat([ray.origin.T, ray.direction.T, ray.throughput.T, ray.emission.T])
    iv[_DEPTH, lane] = depth.to(torch.int32)
    iv[_ALIVE, lane] = alive.to(torch.int32)
    done = torch.nonzero(~alive).squeeze(1)
    out[:, iv[_GEN, lane[done]].long() * lanes + lane[done]] = result[done].T
    if hist is not None:
        hist += torch.bincount(depth[done] - 1, minlength=cfg.max_depth)[:cfg.max_depth]


def megakernel_step_reference(state: LaneState, table, cam, dyn, *, cfg: RenderConfig,
                              n_cells: int, n_items: int, lanes: int, out, seg,
                              seg_slot: int, steps: int = 1, ior: float = 2.0,
                              hist=None) -> None:
    """Plain PyTorch version of ``megakernel_step``: the same arguments and
    in-place updates, in the table's dtype (float32 or float64) and with
    either jitter.  ``steps`` wavefront iterations of every lane, each:

    1. regeneration (``make_step_math``, ``megakernel.py:171-236``, without
       the ring's ``g_flush + K`` gate): an idle lane with ``gen + 1 <
       n_gens`` advances ``gen`` and, when ``item = gen * lanes + lane <
       n_items``, starts that item's camera path;
    2. one ``ops/integrator.bounce_step`` of every live lane with its own
       ``rng.bounce_uniforms(k0, k1, depth)``, then the depth limit;
    3. retirement: a finished path's radiance goes to ``out[:, item]``.

    ``seg[seg_slot + j]`` gains the lanes alive after regeneration in
    iteration j (its path segments).  With ``hist`` ([max_depth] int64),
    ``hist[d - 1]`` gains the paths that finished after d segments.  This
    version also stores the path of a lane that went idle; the kernel does
    not (``lane_state_equal``)."""
    _check(table, cam, dyn)
    _check_step(state, table, n_cells=n_cells, n_items=n_items, lanes=lanes, out=out,
                seg=seg, seg_slot=seg_slot, steps=steps)
    spheres, camera = _unpack(table, cam, ior)
    for j in range(steps):
        _one_step_reference(state, spheres, camera, table, dyn, cfg=cfg, n_cells=n_cells,
                            n_items=n_items, lanes=lanes, out=out, seg=seg,
                            seg_slot=seg_slot + j, hist=hist)


def _step_launcher(state: LaneState, table, cam, dyn, *, cfg: RenderConfig, n_cells: int,
                   n_items: int, lanes: int, out, seg, steps: int, ior: float):
    """Check the arguments of a launch of the per-step kernel once and return
    ``launch(seg_slot)``, which enqueues it on the current stream of the
    table's device (the caller has made that device current) and raises
    RuntimeError if the launch is refused.  The closure keeps the tensors
    and the parameter block it points into alive, and reads that block on
    the host at each launch."""
    if table.device.type != "cuda":
        raise ValueError(f"megakernel_step runs on CUDA or the CPU, not {table.device}")
    check_kernel_config(cfg, table.dtype)
    _check_step(state, table, n_cells=n_cells, n_items=n_items, lanes=lanes, out=out,
                seg=seg, seg_slot=0, steps=steps)
    if not all(t.is_contiguous() for t in (table, cam, state.f, state.i, out, seg)):
        raise ValueError("table, cam, state, out and seg must be contiguous")
    n = table.shape[0]
    if not 1 <= n <= MAX_SPHERES:
        raise ValueError(f"the CUDA kernel holds 1..{MAX_SPHERES} spheres in shared "
                         f"memory, got {n}")
    lib = _build.load()
    params = launch_params(cfg, dyn, n_spheres=n, n_cells=n_cells, n_items=n_items, ior=ior)

    def launch(seg_slot: int) -> None:
        if not 0 <= seg_slot <= seg.shape[0] - steps:
            raise ValueError(f"seg holds no slots {seg_slot}..{seg_slot + steps - 1}")
        # The current stream, asked at each launch: under a graph capture it
        # is the capturing one.
        err = lib.pt_megakernel_step(table.data_ptr(), cam.data_ptr(), state.f.data_ptr(),
                                     state.i.data_ptr(), out.data_ptr(),
                                     seg.data_ptr() + 8 * seg_slot, ctypes.addressof(params),
                                     lanes, steps, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"megakernel_step launch failed: "
                               f"{lib.pt_error_string(err).decode()} ({err})")

    return launch


def megakernel_step(state: LaneState, table, cam, dyn, *, cfg: RenderConfig, n_cells: int,
                    n_items: int, lanes: int, out, seg, seg_slot: int, steps: int = 1,
                    ior: float = 2.0) -> None:
    """``steps`` wavefront iterations of a pool of ``lanes`` lanes, in place.

    Args:
      state: ``LaneState`` (``init_lane_state`` before the first step);
      table: [N,17] (pack_scene); cam: [20] (pack_camera); dyn:
        (cell_start, sample_start) as ints;
      out: [3, n_items], where a path that finishes writes its radiance at
        its item, item = sample * n_cells + c;
      seg: int64 [S]; ``seg[seg_slot + j]`` gains iteration j's path
        segments, j < steps <= ``MAX_STEPS``.

    One call is ``steps`` calls of one step, but for the path rows of idle
    lanes (``lane_state_equal``).  On CUDA tensors this launches the
    per-step kernel once (float32, contiguous, N <= MAX_SPHERES, uniform
    jitter) or raises.  On CPU tensors it runs the plain version.
    ``megakernel_step.launches`` counts the launches.
    """
    _check(table, cam, dyn)
    if table.device.type == "cpu":
        megakernel_step_reference(state, table, cam, dyn, cfg=cfg, n_cells=n_cells,
                                  n_items=n_items, lanes=lanes, out=out, seg=seg,
                                  seg_slot=seg_slot, steps=steps, ior=ior)
        return
    launch = _step_launcher(state, table, cam, dyn, cfg=cfg, n_cells=n_cells, n_items=n_items,
                            lanes=lanes, out=out, seg=seg, steps=steps, ior=ior)
    with torch.cuda.device(table.device):
        launch(seg_slot)
    megakernel_step.launches += 1


megakernel_step.launches = 0


def megakernel_step_batch(state: LaneState, table, cam, dyn, *, batch: int, cfg: RenderConfig,
                          n_cells: int, n_items: int, lanes: int, out, seg, steps: int = 1,
                          ior: float = 2.0):
    """A batch of ``batch`` launches of ``megakernel_step`` as one CUDA graph,
    for the card only.  A batch zeroes ``seg`` (int64 [batch * steps]) and
    launches the kernel ``batch`` times, launch b counting into
    ``seg[b * steps:(b + 1) * steps]``.

    The call checks the arguments once, runs the first batch launch by
    launch (which also makes the library and the kernel resident before the
    capture), captures the same launches on a side stream, and returns
    ``replay()``, which enqueues one more batch on the current stream.
    Nothing in a batch depends on how many ran before it, which is what
    lets one captured graph serve the whole render.  A failed launch,
    capture or replay raises.  ``megakernel_step.launches`` gains ``batch``
    per batch that runs (none for the capture, which launches nothing).

    The capture uses ``torch.cuda.CUDAGraph`` directly: the
    ``torch.cuda.graph`` context first synchronises and empties the caching
    allocator, which a render pays for on every call.
    """
    _check(table, cam, dyn)
    if table.device.type != "cuda":
        raise ValueError(f"a captured batch is for a CUDA device, not {table.device}: on the "
                         "CPU call megakernel_step launch by launch")
    if int(batch) != batch or batch < 1:
        raise ValueError(f"batch must be a positive integer, got {batch!r}")
    launch = _step_launcher(state, table, cam, dyn, cfg=cfg, n_cells=n_cells, n_items=n_items,
                            lanes=lanes, out=out, seg=seg, steps=steps, ior=ior)
    if seg.shape[0] != batch * steps:
        raise ValueError(f"seg must hold batch * steps = {batch * steps} slots, "
                         f"got {seg.shape[0]}")

    def enqueue() -> None:
        seg.zero_()
        for b in range(batch):
            launch(b * steps)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(table.device):
        enqueue()
        megakernel_step.launches += batch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                enqueue()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)

    # The graph holds raw pointers into these tensors: they live as long as it.
    def replay(_held=(state, table, cam, out, seg)) -> None:
        graph.replay()
        megakernel_step.launches += batch

    return replay
