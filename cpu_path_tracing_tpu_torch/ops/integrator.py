"""Batched radiance integrator (plain PyTorch).

Counterpart of ``cpu_path_tracing_tpu/ops/integrator.py``: a batch of rays
advances one bounce per step; dead rays are masked and frozen.  Estimator
semantics match the reference bounce for bounce (``src/main.cpp:104-158``):

* accumulates ``emission_0 + refl_0*emission_1 + ...``;
* on a miss: + throughput * background gradient, ``t = 0.5*(unit_dir.y+1)``;
* Russian roulette after depth > rr_depth with survival ``p = max(albedo)``
  uncapped (the disco light has p = 1.92 and is only damped);
* material dispatch per ``src/main.cpp:141-154``;
* depth exhaustion returns the accumulated emission (``src/main.cpp:157``).

This is the plain version of the CUDA kernel's bounce (``csrc/step_math.cuh``
holds the same expressions); the render runs it on the CPU.  It is also the
differentiable estimator: under torch autograd either loop of ``radiance``
gives the detached-decision gradients of the JAX package's ``scan`` loop
(hit ids, roulette and the dielectric branch are piecewise constant, so
gradients flow through t, the normals, the Fresnel weights and the
throughput; visibility edges are not sampled, so closed scenes such as
``box`` have exactly zero geometry gradients).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from . import rng as rng_ops
from .intersect import hit_record, intersect_scene, rsqrt_safe, sphere_props
from .materials import scatter


class RayState(NamedTuple):
    origin: torch.Tensor  # [B,3]
    direction: torch.Tensor  # [B,3]
    throughput: torch.Tensor  # [B,3] "accumulated_reflectance" (main.cpp:108)
    emission: torch.Tensor  # [B,3] "accumulated_emission" (main.cpp:107)
    alive: torch.Tensor  # [B] bool
    result: torch.Tensor  # [B,3] radiance of finished rays


def init_state(origins, directions) -> RayState:
    zero = torch.zeros_like(origins)
    return RayState(origin=origins, direction=directions, throughput=zero + 1.0,
                    emission=zero, alive=torch.ones_like(origins[:, 0], dtype=torch.bool),
                    result=zero)


def bounce_step(scene, state: RayState, uniforms, depth, *, rr_depth, epsilon, inf,
                with_aux: bool = False):
    """Advance every live ray one bounce.  ``uniforms``: [B,4] (ops/rng.py);
    ``depth``: int or [B].  ``scene`` needs the sphere fields plus
    ``background`` and ``ior``.

    ``with_aux`` also returns the per-ray bounce internals the replay
    backward consumes: hit flags and ids, the pre-bounce throughput, this
    bounce's emission pickup, sky value and lerp t, the roulette decision."""
    o, d, thr, emit, alive, result = state
    u_rr, u_a, u_b = uniforms[:, 0], uniforms[:, 1], uniforms[:, 2]

    t, hid, hit = intersect_scene(scene, o, d, epsilon=epsilon, inf=inf)

    # ---- miss: background gradient (src/main.cpp:115-120) ----
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    a_quad = dx * dx + dy * dy + dz * dz
    dinv = rsqrt_safe(a_quad)
    # (dy*dinv)*0.5 + 0.5: x*0.5 is exact, so any fma grouping rounds alike.
    sky_t = (dy * dinv) * 0.5 + 0.5
    bg = scene.background.to(o.dtype)
    # One-product lerp form bg0 + t*(bg1-bg0).
    sky = bg[0] + sky_t[:, None] * (bg[1] - bg[0])
    die_miss = alive & ~hit
    result = torch.where(die_miss[:, None], emit + thr * sky, result)

    # ---- hit record (finite t on miss rays) ----
    t_safe = torch.where(hit, t, torch.ones_like(t))
    props = sphere_props(scene, hid)
    hp, n_out, normal, front = hit_record(o, d, t_safe, props)
    em_h, al_h = props.emission, props.albedo
    emit_new = emit + thr * em_h  # src/main.cpp:126 (before RR)

    # ---- Russian roulette (src/main.cpp:128-137) ----
    # Uncapped.  amax propagates NaN and splits a tie's gradient evenly, as
    # jnp.max does (nested torch.maximum would give 1/2, 1/4, 1/4).
    p = al_h.amax(dim=-1)
    p_inv = 1.0 / torch.where(p > 0, p, torch.ones_like(p))
    do_rr = torch.as_tensor(depth, device=o.device) > rr_depth
    survive = u_rr < p
    killed = do_rr & ~survive
    result = torch.where((alive & hit & killed)[:, None], emit_new, result)
    colf = torch.where(do_rr & survive, p_inv, torch.ones_like(p_inv))
    thr_new = thr * al_h * colf[:, None]  # src/main.cpp:139

    # ---- scatter (src/main.cpp:141-154) ----
    d_new = scatter(props.mat_mask, d, n_out, normal, front, u_a, u_b, ior=scene.ior)

    cont = alive & hit & ~killed
    cm = cont[:, None]
    new_state = RayState(
        origin=torch.where(cm, hp, o),
        direction=torch.where(cm, d_new, d),
        throughput=torch.where(cm, thr_new, thr),
        emission=torch.where((alive & hit)[:, None], emit_new, emit),
        alive=cont,
        result=result,
    )
    if with_aux:
        aux = {
            "hit": hit, "hid": hid, "thr_pre": thr, "em_h": em_h,
            "sky": sky, "sky_t": sky_t, "die_miss": die_miss,
            "rr_scaled": do_rr & survive, "cont": cont, "was_alive": alive,
        }
        return new_state, aux
    return new_state


def _bounces(scene, st: RayState, keys, depths, *, sync: bool, remat: bool, kw):
    """Run ``bounce_step`` at each depth of ``depths``.  ``sync``: read the
    live count on the host before each bounce and stop at the first bounce
    with no ray alive (the live counts are ints); else run every bounce
    (the counts are 0-d tensors).  ``remat`` under autograd: each bounce in
    ``torch.utils.checkpoint``, so the backward keeps only the ray state and
    the bounce's uniforms.  The uniforms are drawn outside the checkpoint:
    they depend on no parameter, and the recompute then skips the cipher.
    Returns (state, live counts, one per bounce run)."""
    live = []
    for depth in depths:
        n = st.alive.sum()
        if sync:
            n = int(n)
            if n == 0:
                break
        live.append(n)
        u = rng_ops.bounce_uniforms(keys[0], keys[1], depth).to(st.origin.dtype)
        if remat and torch.is_grad_enabled():
            st = RayState(*checkpoint(
                lambda *a, depth=depth: tuple(bounce_step(scene, RayState(*a[:6]), a[6], depth,
                                                          **kw)),
                *st, u, use_reentrant=False))
        else:
            st = bounce_step(scene, st, u, depth, **kw)
    return st, live


def radiance(scene, origins, directions, keys, *, max_depth=100, rr_depth=4,
             epsilon=1e-4, inf=1e20, loop="while", with_stats=False, remat=False):
    """Radiance [B,3] of a ray batch.  ``keys``: ([B],[B]) per-sample item
    keys.

    ``loop``: 'while' stops at the first bounce with no ray alive (one host
    sync a bounce); 'scan' runs all ``max_depth`` bounces without a sync.
    Dead rays are frozen by ``torch.where``, so both give the same radiance
    and, under autograd, the same gradients.  ``remat``: wrap each bounce
    in ``torch.utils.checkpoint`` when autograd records (JAX:
    ``jax.checkpoint`` of the scan step).

    With ``with_stats`` also ``{'segments': live rays summed over bounces,
    'depth': bounces run}``, ints for 'while'; for 'scan' 0-d tensors and
    ``'live_per_depth'``, the live count before each bounce [max_depth]."""
    if loop not in ("while", "scan"):
        raise ValueError(f"unknown loop {loop!r}: 'while' or 'scan'")
    kw = dict(rr_depth=rr_depth, epsilon=epsilon, inf=inf)
    st, live = _bounces(scene, init_state(origins, directions), keys, range(max_depth),
                        sync=loop == "while", remat=remat, kw=kw)
    out = torch.where(st.alive[:, None], st.emission, st.result)
    if not with_stats:
        return out
    if loop == "while":
        return out, {"segments": sum(live), "depth": len(live)}
    per_depth = (torch.stack(live) if live
                 else torch.zeros(0, dtype=torch.int64, device=origins.device))
    return out, {"segments": per_depth.sum(), "depth": torch.tensor(max_depth),
                 "live_per_depth": per_depth}


def radiance_compact(scene, origins, directions, keys, *, max_depth=100, rr_depth=4,
                     epsilon=1e-4, inf=1e20, schedule, loop="scan", remat=True):
    """``radiance`` with live-ray compaction at stage boundaries (JAX
    ``ops/integrator.radiance_compact``).

    ``schedule``: stage lengths in bounces, summing to ``max_depth``
    (``grad.tune_backward_schedule``).  At each boundary the finished rays
    retire their radiance into the output and the live rays are gathered,
    by index, into the next stage's batch; the run ends at a boundary with
    no ray alive.  The compaction is exact: unlike the JAX package's
    capacity-bounded buffers, no live ray is ever dropped, so there is no
    ``dropped`` count.  The per-ray math is ``radiance``'s, so the radiance
    is the plain loop's; a stage runs its bounces as ``loop`` says.  The
    gathers' backward adds each ray's gradient once, so it repeats bitwise on
    the card.  Returns [B,3]."""
    if sum(schedule) != max_depth:
        raise ValueError(f"schedule {schedule} does not cover max_depth={max_depth}")
    kw = dict(rr_depth=rr_depth, epsilon=epsilon, inf=inf)
    st = init_state(origins, directions)
    orig = torch.arange(origins.shape[0], device=origins.device)
    out = torch.zeros_like(origins)
    d0 = 0
    for i, n_steps in enumerate(schedule):
        if i:
            # Retire the rays that finished (a live ray's result is 0) and
            # keep the live ones.
            out = out.index_add(0, orig, torch.where(st.alive[:, None], 0.0, st.result))
            live = torch.nonzero(st.alive).squeeze(1)
            if not live.numel():
                return out
            st = RayState(*(x[live] for x in st[:5]), result=torch.zeros_like(st.result[live]))
            keys, orig = (keys[0][live], keys[1][live]), orig[live]
        st, live_counts = _bounces(scene, st, keys, range(d0, d0 + n_steps),
                                   sync=loop == "while", remat=remat, kw=kw)
        if len(live_counts) < n_steps:  # 'while' found no ray alive
            break
        d0 += n_steps
    return out.index_add(0, orig, torch.where(st.alive[:, None], st.emission, st.result))
