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
holds the same expressions); the render runs it on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def radiance(scene, origins, directions, keys, *, max_depth=100, rr_depth=4,
             epsilon=1e-4, inf=1e20, loop="while", with_stats=False):
    """Radiance [B,3] of a ray batch.  ``keys``: ([B],[B]) per-sample item
    keys.  With ``with_stats`` also ``{'segments': live rays summed over
    bounces (int), 'depth': bounce steps run (int)}``."""
    if loop != "while":
        raise ValueError(f"loop={loop!r} is not ported yet; only 'while' "
                         "(ROADMAP.md Queue 1, the geometry and camera backward, ports "
                         "the scan loop)")
    st = init_state(origins, directions)
    kw = dict(rr_depth=rr_depth, epsilon=epsilon, inf=inf)
    segments = 0
    depth = 0
    while depth < max_depth:
        live = int(st.alive.sum())
        if live == 0:
            break
        segments += live
        u = rng_ops.bounce_uniforms(keys[0], keys[1], depth).to(origins.dtype)
        st = bounce_step(scene, st, u, depth, **kw)
        depth += 1
    out = torch.where(st.alive[:, None], st.emission, st.result)
    if with_stats:
        return out, {"segments": segments, "depth": depth}
    return out
