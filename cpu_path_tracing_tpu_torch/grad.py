"""Differentiable rendering and inverse rendering.

Counterpart of ``cpu_path_tracing_tpu/grad.py``.  Every field of
``OPTIMIZABLE`` differentiates on the scene's device; the sharded steps
(``make_sharded_accum_train_step``, ``make_sharded_train_step``) spread the
same work over a ('tiles', 'samples') mesh of devices, in one process (the
accumulating step on a mesh over several devices: a worker process a
device).

The rendered cell sum is a ``torch.autograd.Function`` (``_RenderSpan``)
with a decoupled forward and backward, as the JAX package's custom VJP:

* forward: ``render_cells_range`` on the fast route (the forward kernel on
  the card), without a tape;
* backward, by one of three routes chosen from the fields, the scene and
  the config before anything launches (``backward_route``):

  - 'replay', every field in ``OPTIMIZABLE_REPLAY`` (JAX ``grad.py:259``):
    the analytic replay (``ops/replay.replay_param_grads_auto``: the replay
    kernel on the card where it takes the scene, else the plain replay on
    the scene's device);
  - 'geometry', any of p0, radius and camera among the fields of a CUDA
    scene the kernels take: the geometry replay kernel for p0, radius and
    the camera (``ops/kernels/geometry_replay.py``) and the replay kernel
    for whichever of albedo, emission and background are fields too, each
    one launch a span;
  - 'scan', everything else (the CPU, float64, tent jitter, more than 40
    spheres, ``replay=False``): the scan VJP, each ``sample_chunk`` of the
    span recomputed under autograd through the batch route with the
    backward config (``_compact_bwd_cfg``: checkpointed bounces, live-ray
    compaction on a pilot-tuned schedule) and contracted with the
    cotangent by ``torch.autograd.grad`` (JAX ``_contracted_render_sum``).

The loss lives in linear radiance on subpixel cells, before the clamp of
``src/main.cpp:195-196``.

Parameters are a dict of field tensors.  ``camera`` is a ``CameraConfig``
whose eight fields are the leaves (the JAX pytree's), and its gradient is a
``CameraConfig`` of the same eight fields.
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, Optional

import torch

from .config import RenderConfig
from .models.camera import FIELDS as CAMERA_FIELDS
from .models.camera import CameraConfig
from .models.scene import SPHERE_FIELDS, Scene
from .ops.integrator import radiance
from .ops.kernels.geometry_replay import geometry_param_grads_kernel
from .ops.kernels.replay import replay_kernel_takes, replay_param_grads_kernel
from .ops.replay import replay_param_grads_auto
from .parallel import spmd
from .parallel.cards import CardShards
from .parallel.mesh import SAMPLE_AXIS, TILE_AXIS, Mesh
from .parallel.render import replicate_scene, samples_per_shard, sum_shards
from .render import camera_rays, render_cells_range
from .utils import debug
from .utils.profiling import annotate

# Scene fields that may be optimized.
OPTIMIZABLE = ("p0", "radius", "albedo", "emission", "camera", "background")
# Fields whose gradients the analytic replay backward covers (multilinear in
# the estimator, ops/replay.py); the rest take the geometry replay on the
# card (ops/geometry_replay.py) or the scan VJP.
OPTIMIZABLE_REPLAY = ("albedo", "emission", "background")


def backward_route(scene, cfg: RenderConfig, fields, replay: bool = True) -> str:
    """The backward of a span for ``fields``, chosen before anything
    launches (module docstring): 'replay' when ``replay`` is on and every
    field is in ``OPTIMIZABLE_REPLAY``; 'geometry' when ``replay`` is on and
    the scene is on a CUDA device in a config the replay kernels take
    (``ops/kernels/replay.replay_kernel_takes``: float32, uniform jitter,
    1..40 spheres); else 'scan'.  Reads only the scene's device, dtype and
    sphere count."""
    if not replay:
        return "scan"
    if set(fields) <= set(OPTIMIZABLE_REPLAY):
        return "replay"
    if scene.device.type == "cuda" and replay_kernel_takes(cfg, scene.dtype, scene.num_spheres):
        return "geometry"
    return "scan"


def split_params(scene: Scene, fields=("p0", "radius", "albedo")) -> Dict[str, object]:
    """The optimizable fields of a scene, by name."""
    bad = set(fields) - set(OPTIMIZABLE)
    if bad:
        raise ValueError(f"cannot optimize {sorted(bad)}; allowed: {OPTIMIZABLE}")
    return {f: getattr(scene, f) for f in fields}


def merge_params(scene: Scene, params: Dict[str, object]) -> Scene:
    """A new Scene with ``params`` in place of the scene's fields; the scene
    itself is not changed."""
    fields = {f: getattr(scene, f) for f in SPHERE_FIELDS + ("background",)}
    fields.update({k: v for k, v in params.items() if k != "camera"})
    return Scene(**fields, camera=params.get("camera", scene.camera), ior=scene.ior)


def flatten_params(params: Dict[str, object]):
    """(names, tensors) of the leaves of ``params`` in the JAX pytree's
    order: keys sorted, a camera's eight fields in ``CameraConfig`` order,
    named ``camera.<field>``."""
    names, leaves = [], []
    for k in sorted(params):
        if k == "camera":
            names += [f"camera.{f}" for f in CAMERA_FIELDS]
            leaves += [getattr(params[k], f) for f in CAMERA_FIELDS]
        else:
            names.append(k)
            leaves.append(params[k])
    return tuple(names), tuple(leaves)


def unflatten_params(names, leaves) -> Dict[str, object]:
    """The inverse of ``flatten_params``."""
    out, cam = {}, {}
    for n, v in zip(names, leaves):
        if n.startswith("camera."):
            cam[n[len("camera."):]] = v
        else:
            out[n] = v
    if cam:
        out["camera"] = CameraConfig(**cam)
    return out


def _diff_cfg(cfg: RenderConfig) -> RenderConfig:
    return cfg.replace(loop="scan", integrator="batch")


def cell_loss(params, scene: Scene, cfg: RenderConfig, cell_ids, target_cells,
              sample_start: int = 0, num_samples: Optional[int] = None):
    """Mean squared error between the rendered cell radiance and
    ``target_cells`` [B,3], through the differentiable scan loop."""
    cfg = _diff_cfg(cfg)
    ns = cfg.spp if num_samples is None else num_samples
    cells = render_cells_range(merge_params(scene, params), cfg, cell_ids, sample_start, ns) / ns
    return ((cells - target_cells) ** 2).mean()


def train_step(params, optimizer, scene: Scene, cfg: RenderConfig, cell_ids, target_cells):
    """One inverse-rendering step on ``cell_loss``: ``optimizer`` is a
    ``torch.optim`` optimizer over the leaves of ``params``
    (``flatten_params``, tensors that require grad), which it updates in
    place.  Returns (params, the loss before the step)."""
    optimizer.zero_grad(set_to_none=True)
    loss = cell_loss(params, scene, cfg, cell_ids, target_cells)
    loss.backward()
    optimizer.step()
    return params, loss.detach()


def tune_backward_schedule(scene: Scene, cfg: RenderConfig, *, group: int = 4,
                           min_frac: float = 1.0 / 64, probe_cells: int = 1 << 14):
    """Stage boundaries for the live-ray compaction of the scan VJP
    (``ops/integrator.radiance_compact``) from a pilot survival curve (JAX
    ``grad.py:76-124``).

    One sample of the scan loop over a strided ~``probe_cells`` cell subset
    gives the live count before each bounce.  A new stage opens at a
    multiple of ``group`` bounces where the live fraction (floored at
    ``min_frac``) has fallen to a third of the current stage's or below:
    each boundary costs a host sync and a gather of the ray state, so only a
    3x drop pays for one.  Returns a tuple of stage lengths, or None when
    the curve does not fall that far (one stage is the plain loop)."""
    n = cfg.num_cells
    ids = torch.arange(0, n, max(1, n // probe_cells), device=scene.device)
    with torch.no_grad():
        keys, o, d = camera_rays(scene, cfg, ids, 0, scene.dtype)
        _, st = radiance(scene, o, d, keys, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                         epsilon=cfg.epsilon, inf=cfg.inf, loop="scan", with_stats=True)
    curve = st["live_per_depth"].double().cpu() / ids.shape[0]
    stages: list[list] = []  # [n_steps, live fraction at the stage's start]
    for d0 in range(0, cfg.max_depth, group):
        g = min(group, cfg.max_depth - d0)
        frac = min(1.0, max(float(curve[d0]), min_frac))
        if stages and frac > stages[-1][1] / 3.0:
            stages[-1][0] += g
        else:
            stages.append([g, frac])
    if len(stages) <= 1:
        return None
    return tuple(int(s) for s, _ in stages)


def backward_drop_count(scene: Scene, cfg: RenderConfig, num_cells: int, params=None,
                        sample_idx: int = 0) -> int:
    """Live rays the compacted backward truncates: 0 by construction.  The
    JAX package gathers live lanes into buffers of a pilot-tuned capacity
    and counts the ones that do not fit (JAX ``grad.py:127-150``);
    ``radiance_compact`` gathers exactly the live rays, by index, so it
    drops none.  Kept with the JAX signature for ``step.drop_check`` and
    ``cli invert``'s record."""
    return 0


def _compact_bwd_cfg(scene: Scene, cfg: RenderConfig, compact: bool) -> RenderConfig:
    """The scan VJP's config (the 'scan' route of ``backward_route``): the
    batch route with the 'while' loop and checkpointed bounces, plus a
    pilot-tuned compaction schedule when ``compact`` and the scene's
    survival curve falls (a caller's explicit schedule wins; shallow renders
    are not worth the pilot).  Built once a span, on its first scan VJP
    (``_Span.bwd_cfg``).  'while' stops at the first bounce with no ray
    alive, for a host sync a bounce; the JAX package's 'scan' runs every
    bounce, as its autodiff needs.  Both give the same gradients.  On the
    card this route's recompute is bound by its launches (the 'geometry'
    route takes a float32 scene the kernels take to one launch a span):
    early exit saves none on a full chunk (some path lives to max_depth)
    and a fifth of a simple 400x400 step's, whose last chunk ends early
    (PERF.md, Findings PR 7)."""
    bwd = cfg.replace(loop="while", integrator="batch", remat=True)
    if compact and bwd.compact_schedule is None and cfg.max_depth >= 16:
        sched = tune_backward_schedule(scene, bwd)
        if sched is not None:
            bwd = bwd.replace(compact_schedule=sched)
    return bwd


class _Span:
    """What a span's forward and backward run with.  ``bwd_cfg``, the scan
    VJP's config, is built on first use: its pilot runs only on the 'scan'
    route, never for a step whose backward is a replay."""

    def __init__(self, scene: Scene, cfg: RenderConfig, spp: int, chunk: int, compact: bool,
                 replay: bool):
        self.scene, self.cfg, self.spp, self.chunk = scene, cfg, spp, chunk
        self.compact, self.replay = compact, replay
        self.fwd_cfg = cfg.replace(loop="while")

    @functools.cached_property
    def bwd_cfg(self) -> RenderConfig:
        return _compact_bwd_cfg(self.scene, self.cfg, self.compact)

    def route(self, fields) -> str:
        """The backward route for ``fields`` (``backward_route``)."""
        return backward_route(self.scene, self.cfg, fields, self.replay)


def _scan_vjp(span: _Span, cell_ids, sample_start: int, names, values, ct):
    """Gradients of ``sum(ct * render_sum)`` with respect to ``values``:
    each sample chunk recomputed under autograd on the batch route."""
    total = None
    with torch.enable_grad():
        leaves = [v.detach().requires_grad_(True) for v in values]
        sc = merge_params(span.scene, unflatten_params(names, leaves))
        for s0 in range(sample_start, sample_start + span.spp, span.chunk):
            out = render_cells_range(sc, span.bwd_cfg, cell_ids, s0, span.chunk)
            g = torch.autograd.grad(out, leaves, grad_outputs=ct, allow_unused=True,
                                    materialize_grads=True)
            total = g if total is None else tuple(a + b for a, b in zip(total, g))
    return total


class _RenderSpan(torch.autograd.Function):
    """Per-cell radiance sum over a sample span: forward on the fast route,
    backward by the route ``backward_route`` chose."""

    @staticmethod
    def forward(ctx, span, route, cell_ids, sample_start, names, *values):
        ctx.args = (span, route, cell_ids, sample_start, names)
        ctx.save_for_backward(*values)
        sc = merge_params(span.scene, unflatten_params(names, values))
        return render_cells_range(sc, span.fwd_cfg, cell_ids, sample_start, span.spp)

    @staticmethod
    def backward(ctx, ct):
        span, route, cell_ids, sample_start, names = ctx.args
        values = ctx.saved_tensors
        if route == "scan":
            return (None,) * 5 + _scan_vjp(span, cell_ids, sample_start, names, values, ct)
        sc = merge_params(span.scene, unflatten_params(names, values))
        args = (sc, span.fwd_cfg, cell_ids, sample_start, span.spp, ct)
        fields = {n.partition(".")[0] for n in names}
        g = {}
        if route == "geometry":
            # The camera's partials go through an autograd pass of
            # build_camera, hundreds of small launches a span: only when
            # the camera is a field.
            g.update(geometry_param_grads_kernel(*args, camera="camera" in fields))
            if fields & set(OPTIMIZABLE_REPLAY):
                g.update(replay_param_grads_kernel(*args))
        else:
            g.update(replay_param_grads_auto(*args))
        leaves = dict(zip(*flatten_params({f: g[f] for f in fields})))
        return (None,) * 5 + tuple(leaves[n].to(v.dtype) for n, v in zip(names, values))


def make_diff_render_span(scene: Scene, cfg: RenderConfig, spp_span: int,
                          sample_chunk: Optional[int] = None, compact: bool = True,
                          replay: bool = True):
    """Differentiable per-cell radiance SUM over ``spp_span`` samples from a
    ``sample_start``: ``render_sum(params, cell_ids, sample_start) -> [B,3]``,
    differentiable with respect to ``params`` (any fields of
    ``OPTIMIZABLE``).  ``cell_ids`` is a contiguous cell span: a host
    ``range``, or an id tensor, which alone the forward and the backward's
    kernel wrappers read back from its device
    (``ops/kernels/megakernel.cell_span``); the routes that take any id set
    make a range a ``torch.arange`` on the device.  The forward takes the
    config's route; the backward recomputes ``sample_chunk`` samples at a
    time (the memory knob: one chunk's tape at a time), or runs the replay
    (module docstring).  ``render_sum.span.bwd_cfg`` is the scan VJP's config."""
    chunk = sample_chunk or spp_span
    if spp_span % chunk:
        raise ValueError(f"sample_chunk={chunk} must divide span={spp_span}")
    span = _Span(scene, cfg, spp_span, chunk, compact, replay)

    def render_sum(params, cell_ids, sample_start: int = 0):
        split_params(scene, tuple(params))  # raises for a field outside OPTIMIZABLE
        names, values = flatten_params(params)
        return _RenderSpan.apply(span, span.route(params), cell_ids, int(sample_start), names,
                                 *values)

    render_sum.span = span
    return render_sum


def make_diff_render(scene: Scene, cfg: RenderConfig, sample_chunk: Optional[int] = None,
                     compact: bool = True, replay: bool = True):
    """Differentiable per-cell MEAN radiance over ``cfg.spp`` samples:
    ``render_mean(params, cell_ids) -> [B,3]`` (``make_diff_render_span``)."""
    render_sum = make_diff_render_span(scene, cfg, cfg.spp, sample_chunk, compact=compact,
                                       replay=replay)

    def render_mean(params, cell_ids):
        return render_sum(params, cell_ids, 0) / cfg.spp

    render_mean.span = render_sum.span
    return render_mean


def make_accum_loss_grad(scene: Scene, cfg: RenderConfig, *, cell_chunk: Optional[int] = None,
                         sample_chunk: Optional[int] = None, compact: bool = True,
                         replay: bool = True):
    """The full-image loss and its gradient, accumulated over chunks.

    Returns ``loss_grad(params, targets) -> (loss, grads)``: ``loss`` is the
    full-image MSE against the [num_cells, 3] mean-radiance ``targets`` (a
    0-d tensor), ``grads`` its gradient with respect to each of ``params``
    (``camera``: a ``CameraConfig``), both summed over contiguous
    ``cell_chunk``-cell spans and divided by ``3 * num_cells`` once at the
    end (the chunk loop of the JAX package's ``make_accum_train_step``).
    ``loss_grad.span.bwd_cfg`` is the scan VJP's config.  Inside
    ``utils/debug.debug_context`` both are checked for NaN.  It is
    ``make_sharded_accum_loss_grad`` on the 1x1 mesh of the scene's device."""
    return make_sharded_accum_loss_grad(Mesh(((scene.device,),)), scene, cfg,
                                        cell_chunk=cell_chunk, sample_chunk=sample_chunk,
                                        compact=compact, replay=replay)


def make_accum_train_step(scene: Scene, cfg: RenderConfig, lr: float, *,
                          cell_chunk: Optional[int] = None, sample_chunk: Optional[int] = None,
                          compact: bool = True, replay: bool = True):
    """Inverse rendering at full image size: one Adam step per call.

    Returns ``step(params, targets) -> (params, loss)``.  ``targets`` is the
    [num_cells, 3] mean-radiance target; ``loss`` the full-image MSE (a 0-d
    tensor) at the given ``params``, which are updated once from the
    gradient of ``make_accum_loss_grad``.  The returned params are new
    tensors.

    The step keeps ``torch.optim.Adam`` (optax.adam's betas and eps) and its
    moments across calls, over every leaf (``flatten_params``: a camera's
    eight fields each): its first call takes the params to optimize, later
    calls continue from the params they are given.  With ``compact``,
    ``step.drop_check(params)`` is the JAX monitor (``backward_drop_count``)
    of the last step's backward; ``step.span.bwd_cfg`` the scan VJP's config.

    ``step.state_dict()`` is ``{"params": ..., "optimizer": ...}``: copies of
    the params and of Adam's ``state_dict()``, whose per-leaf ``step``
    counter and moments stay where Adam keeps them (the counter a float32
    CPU tensor, the moments on the params' device).  ``step.load_state_dict``
    takes such a dict, also in a step function that has not run yet, and
    hands it to ``Adam.load_state_dict``, which casts nothing that was saved
    in the params' dtype; the ``param_groups`` may be left out (the step's
    own are used).  Continuing from a loaded state repeats the
    uninterrupted steps bitwise (``utils/checkpoint.InvertState``)."""
    n = cfg.num_cells
    cc = min(cell_chunk or n, n)
    loss_grad = make_accum_loss_grad(scene, cfg, cell_chunk=cell_chunk,
                                     sample_chunk=sample_chunk, compact=compact, replay=replay)
    step = _adam_step(loss_grad, lr)
    step.span = loss_grad.span
    if compact:
        def drop_check(params=None):
            # Nothing was compacted before a first step, nor by a replay step.
            names = step.leaf_names()
            if names is None or step.span.route({k.partition(".")[0] for k in names}) != "scan":
                return 0
            return backward_drop_count(scene, step.span.bwd_cfg, cc, params=params)

        step.drop_check = drop_check
    return step


def _adam_step(loss_grad, lr: float):
    """One Adam step a call over ``loss_grad(params, targets) -> (loss,
    grads)``, with the state of ``make_accum_train_step``'s docstring."""
    state = {}

    def init(names, values):
        state["names"] = names
        state["leaves"] = [v.detach().clone().requires_grad_(True) for v in values]
        state["opt"] = torch.optim.Adam(state["leaves"], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(params, targets):
        with annotate("pt.step"):
            names, values = flatten_params(params)
            if not state:
                init(names, values)
            leaves, opt = state["leaves"], state["opt"]
            if names != state["names"]:
                raise ValueError(f"step was built for {state['names']}, got {names}")
            with annotate("pt.adam"), torch.no_grad():
                for leaf, v in zip(leaves, values):
                    if v is not leaf:
                        leaf.copy_(v)
            loss, grads = loss_grad(unflatten_params(names, leaves), targets)
            with annotate("pt.adam"):
                for leaf, g in zip(leaves, flatten_params(grads)[1]):
                    leaf.grad = g
                opt.step()
                return unflatten_params(names, [v.detach().clone() for v in leaves]), loss

    def state_dict():
        if not state:
            raise RuntimeError("the step has no state before its first call or a load")
        sd = copy.deepcopy(state["opt"].state_dict())
        return {"params": unflatten_params(state["names"],
                                           [v.detach().clone() for v in state["leaves"]]),
                "optimizer": sd}

    def load_state_dict(sd):
        init(*flatten_params(sd["params"]))
        opt_sd = dict(sd["optimizer"])
        opt_sd.setdefault("param_groups", state["opt"].state_dict()["param_groups"])
        state["opt"].load_state_dict(opt_sd)

    step.state_dict, step.load_state_dict = state_dict, load_state_dict
    step.leaf_names = lambda: state.get("names")
    return step


def shard_forward(span, names, leaves, start: int, per: int, sample_start: int):
    """One shard's differentiable sums [per, 3] of cells ``[start, start +
    per)`` from ``sample_start``, through ``span`` (``make_diff_render_span``)
    on the leaves' device.  The cells go as a host ``range``, so no launch
    reads their start back from the device."""
    return span(unflatten_params(names, leaves), range(start, start + per), sample_start)


def shard_backward(sums, leaves, ct, prev):
    """``prev`` plus the gradients of ``sum(ct * sums)`` with respect to
    ``leaves`` (``prev`` None: the gradients alone)."""
    g = torch.autograd.grad(sums, leaves, grad_outputs=ct)
    return g if prev is None else [a + b for a, b in zip(prev, g)]


class _Shards:
    """The shards of a mesh whose entries share one device, run in this
    process through ``parallel/spmd.run``; ``parallel/cards.CardShards``
    has the same methods, a worker process a device."""

    def __init__(self, mesh, spans, spp_local: int):
        self.mesh, self.spans, self.spp_local = mesh, spans, spp_local

    def start(self, names, values) -> None:
        on_device = {d: [v.detach().to(d) for v in values] for d in self.spans}
        # Leaves of each shard's own: autograd keeps a leaf's gradient on the
        # stream of the shard that first used it.
        self.names = names
        self.leaves = [[[v.detach().requires_grad_(True) for v in on_device[d]] for d in row]
                       for row in self.mesh.devices]
        self.acc = [[None] * len(row) for row in self.mesh.devices]

    def forward(self, chunk: int, per: int) -> list:
        self.sums = spmd.run(self.mesh, lambda t, s, d: shard_forward(
            self.spans[d], self.names, self.leaves[t][s], chunk + t * per, per,
            s * self.spp_local))
        return [[x.detach() for x in row] for row in self.sums]

    def backward(self, cts) -> None:
        cts = [[ct.to(d) for d in row] for ct, row in zip(cts, self.mesh.devices)]
        sums, prev = self.sums, self.acc
        self.acc = spmd.run(self.mesh, lambda t, s, d: shard_backward(
            sums[t][s], self.leaves[t][s], cts[t][s], prev[t][s]))
        self.sums = None

    def grads(self) -> list:
        return self.acc

    def close(self) -> None:
        """Nothing to stop: the shards run in this process."""


def make_sharded_accum_loss_grad(mesh, scene: Scene, cfg: RenderConfig, *,
                                 cell_chunk: Optional[int] = None,
                                 sample_chunk: Optional[int] = None, compact: bool = True,
                                 replay: bool = True):
    """``make_accum_loss_grad`` over a ('tiles', 'samples') mesh
    (``parallel/mesh.py``; JAX ``grad.py:389-499``).

    Each ``cell_chunk`` (rounded up to a multiple of ``n_tiles``) is split
    evenly over the tiles; the last chunk's cells are rounded up to a
    multiple of ``n_tiles`` with ids that continue past ``num_cells`` (a
    contiguous span renders on every route), whose 0/1 mask zeroes their
    loss and gradient.  Sample shard s of a tile renders
    samples ``[s*spp_local, (s+1)*spp_local)`` of the tile's cells through
    ``make_diff_render_span`` on its device (the forward kernel, then the
    replay kernels or the scan VJP, on the card).  A chunk runs every
    shard's forward at once; the shards' sums are added in shard order on
    the tile's first device and the loss formed there.  The cotangent of
    every shard's sums is the same, ``ct = 2·mask·(cells - target)/spp``,
    handed to each shard's backward explicitly; then every shard's backward
    runs at once, each adding its gradients over the step's chunks on its
    own device.  Those sums are added once a step, in mesh order, on the
    mesh's first device.  No collective is differentiated, so no gradient
    is counted ``n_samples`` times (the JAX package's psum-vs-pmean trap).

    The shards run in this process, each on its own stream
    (``parallel/spmd.run``), when the mesh's entries share one device, and
    in a worker process a device (``parallel/cards.CardShards``) when they
    span several: one host thread cannot issue several cards' host work as
    fast as they run it (PERF.md, Findings: the mesh's SPMD execution).
    Both add in the same order.  ``loss_grad.close()`` stops the workers
    (also done when ``loss_grad`` is collected).

    Returns ``loss_grad(params, targets) -> (loss, grads)`` as
    ``make_accum_loss_grad`` does, on the mesh's first device, with
    ``loss_grad.span`` that device's span; equal to the one-device loss and
    gradient up to the association of the sums."""
    n = cfg.num_cells
    n_tiles = mesh.shape[TILE_AXIS]
    spp_local = samples_per_shard(cfg, mesh.shape[SAMPLE_AXIS])
    cc = min(cell_chunk or n, n)
    cc = -(-cc // n_tiles) * n_tiles
    first = mesh.devices[0][0]
    kw = dict(compact=compact, replay=replay)
    if len(mesh.distinct_devices()) > 1:
        shards = CardShards(mesh, scene, cfg, spp_local, sample_chunk, max_per=cc // n_tiles,
                            **kw)
        span = make_diff_render_span(scene, cfg, spp_local, sample_chunk, **kw).span
    else:
        spans = {d: make_diff_render_span(sc, cfg, spp_local, sample_chunk, **kw)
                 for d, sc in replicate_scene(scene, mesh).items()}
        shards = _Shards(mesh, spans, spp_local)
        span = spans[first].span

    def loss_grad(params, targets):
        names, values = flatten_params(params)
        with annotate("pt.grad.start"):
            shards.start(names, values)
        sq_sum = None
        for chunk in range(0, n, cc):
            per = -(-(min(chunk + cc, n) - chunk) // n_tiles)
            with annotate("pt.grad.forward"):
                sums = shards.forward(chunk, per)
            with annotate("pt.grad.cotangent"):
                cts = []
                for t, row in enumerate(mesh.devices):
                    start = chunk + t * per
                    dev = row[0]
                    ids = torch.arange(start, start + per, device=dev)
                    mask = (ids < n).to(sums[t][0].dtype)[:, None]
                    target = targets[torch.clamp(ids, max=n - 1).to(targets.device)].to(dev)
                    with torch.no_grad():
                        cells = sum_shards(sums[t], dev) / cfg.spp
                        diff = mask * (cells - target)
                        sq = (diff ** 2).sum().to(first)
                        cts.append(2.0 * diff / cfg.spp)
                    sq_sum = sq if sq_sum is None else sq_sum + sq
            with annotate("pt.grad.backward"):
                shards.backward(cts)
        with annotate("pt.grad.accumulate"):
            grads = None
            for part in (g for row in shards.grads() for g in row):
                part = [x.to(first) for x in part]
                grads = part if grads is None else [a + b for a, b in zip(grads, part)]
            denom = 3 * n
            loss, grads = sq_sum / denom, unflatten_params(names, [g / denom for g in grads])
            debug.guard({"loss": loss, "grads": grads}, "inverse step")
        return loss, grads

    loss_grad.span = span
    loss_grad.close = shards.close
    return loss_grad


def make_sharded_accum_train_step(mesh, scene: Scene, cfg: RenderConfig, lr: float, *,
                                  cell_chunk: Optional[int] = None,
                                  sample_chunk: Optional[int] = None, compact: bool = True,
                                  replay: bool = True):
    """``make_accum_train_step`` over a mesh: one Adam step a call on the
    gradient of ``make_sharded_accum_loss_grad``, with the same
    ``step(params, targets) -> (params, loss)``, ``state_dict`` and
    ``load_state_dict``; the params and Adam's moments live on the mesh's
    first device."""
    return _adam_step(make_sharded_accum_loss_grad(
        mesh, scene, cfg, cell_chunk=cell_chunk, sample_chunk=sample_chunk, compact=compact,
        replay=replay), lr)


def render_target(scene: Scene, cfg: RenderConfig, cell_chunk: Optional[int] = None):
    """Mean-radiance target [num_cells, 3] for inverse rendering, rendered on
    the scene's device in ``cell_chunk``-cell spans."""
    n = cfg.num_cells
    cc = min(cell_chunk or n, n)
    outs = []
    with torch.no_grad():
        for start in range(0, n, cc):
            ids = range(start, min(start + cc, n))
            outs.append(render_cells_range(scene, cfg, ids, 0, cfg.spp) / cfg.spp)
    return torch.cat(outs, dim=0)


def make_sharded_train_step(mesh, cfg: RenderConfig, optimizer):
    """``train_step`` over a ('tiles', 'samples') mesh (JAX
    ``grad.py:521-566``).

    Returns ``step(params, scene, cell_ids, target_cells) -> (params,
    loss)``: ``optimizer`` is a ``torch.optim`` optimizer over the leaves of
    ``params`` (``flatten_params``), ``cell_ids`` (any id set; its length a
    multiple of ``n_tiles``) and ``target_cells`` [len(cell_ids), 3] are split
    evenly over the tiles.  Every shard renders its cells for its sample
    range at once (``parallel/spmd.run``) through the differentiable batch
    route on its device, from copies of the params that autograd carries
    back; a tile's loss term is the mean squared error of its cells over
    ``n_tiles``, and the terms are added in tile order on the mesh's first
    device.  One backward of that sum gives each gradient once (autograd
    runs each device's part on that device's engine thread, on the streams
    the forward used)."""
    cfg = _diff_cfg(cfg)
    n_tiles = mesh.shape[TILE_AXIS]
    spp_local = samples_per_shard(cfg, mesh.shape[SAMPLE_AXIS])
    first = mesh.devices[0][0]

    def step(params, scene: Scene, cell_ids, target_cells):
        if cell_ids.shape[0] % n_tiles:
            raise ValueError(f"{cell_ids.shape[0]} cell ids not divisible by {n_tiles} tiles")
        per = cell_ids.shape[0] // n_tiles
        optimizer.zero_grad(set_to_none=True)
        names, values = flatten_params(params)
        # Copies on the caller's stream, on every device: the params' own
        # gradients then accumulate on the stream that made them.
        local = {d: merge_params(sc, unflatten_params(names, [v.to(d, copy=True)
                                                              for v in values]))
                 for d, sc in replicate_scene(scene, mesh).items()}

        ids = [[cell_ids[t * per:(t + 1) * per].to(d) for d in row]
               for t, row in enumerate(mesh.devices)]

        def forward(t, s, d):
            return render_cells_range(local[d], cfg, ids[t][s], s * spp_local, spp_local)

        sums = spmd.run(mesh, forward)
        loss = None
        for t, row in enumerate(mesh.devices):
            dev = row[0]
            cells = sum_shards(sums[t], dev) / cfg.spp
            target = target_cells[t * per:(t + 1) * per].to(dev)
            term = (((cells - target) ** 2).mean() / n_tiles).to(first)
            loss = term if loss is None else loss + term
        loss.backward()
        optimizer.step()
        return params, loss.detach()

    return step
