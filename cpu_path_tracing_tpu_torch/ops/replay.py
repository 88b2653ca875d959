"""Replay backward: analytic parameter gradients in one forward-speed pass.

Counterpart of ``cpu_path_tracing_tpu/ops/replay.py``.  Albedo, emission and
background enter the estimator multilinearly: with the discrete decisions
held fixed, a path's radiance is

    L = sum_k (prod_{j<k} f_j) * e_k  [+ (prod f_j) * sky on a miss],
    f_j = albedo[h_j] * colf_j,   colf_j = 1/p_j on a surviving roulette,

so each bounce-k contribution c_k depends only on its prefix and

    dL/d a[m,c'] = sum_k c_k[c] * ( cnt_k[m] * delta_cc' / a[m,c]
                                    - rr_k[m] * tiemask[m,c'] / p_m ),
    dL/d e[m,c]  = sum_k [h_k = m] thr_k[c],
    dL/d bg      = thr_miss * (1-t, t),

where cnt_k[m] / rr_k[m] count the (rouletted) prefix hits on sphere m and
``tiemask`` splits the gradient of p = max_c albedo[m,c] evenly among tied
channels, as ``jnp.max`` and ``torch.amax`` do.  All of it accumulates
forward, beside the same bounce math as the render
(``ops/integrator.bounce_step`` with aux): no tape, no fixed trip count.

The raw sums are kept as one vector of ``7N+6`` partials, the layout of the
CUDA kernel (``ops/kernels/replay.py``):

    [0:3N)    cq[m,c]  = sum_k cnt_k[m] * q_k[c]      (albedo numerator)
    [3N:4N)   rr_w[m]  = sum_k cnt_rr_k[m] * sum_c q_k[c]
    [4N:7N)   emission pickups, sphere-major
    [7N:7N+6) background (bottom xyz, top xyz)

where q_k = ct * thr_k * (emission pickup on a hit | sky on a miss), and
``assemble_albedo_grad`` applies the guarded 1/albedo and 1/p at the end.

Scope: albedo, emission and background only (``grad.OPTIMIZABLE_REPLAY``).
An exactly-zero albedo channel gets a zero gradient where autograd gives
the albedo-excluded product (the guarded division; tests pin it).

The JAX package's ``replay_param_grads_wavefront`` (lane regeneration, a
K-slot cotangent ring and a watermark) is not ported: its ring existed
because TPU gathers are slow, and its semantics are those of the kernel's
plain version, ``ops/kernels/replay.replay_persistent_reference``.
"""

from __future__ import annotations

import torch

from . import rng as rng_ops
from .integrator import bounce_step, init_state
from .kernels.megakernel import cell_ids_of


def n_partials(n_spheres: int) -> int:
    return 7 * n_spheres + 6


def partial_blocks(n_spheres: int) -> dict:
    """The four blocks of the partials vector (module docstring), as slices."""
    n = n_spheres
    return {"cq": slice(0, 3 * n), "rr_w": slice(3 * n, 4 * n), "ge": slice(4 * n, 7 * n),
            "gbg": slice(7 * n, 7 * n + 6)}


def assemble_albedo_grad(albedo, cq, rr_w):
    """The albedo gradient from the two raw contractions ``cq`` [N,3] and
    ``rr_w`` [N]: guarded 1/albedo and 1/p, and the even tie split of
    p = max(albedo)."""
    p = albedo.amax(dim=-1)
    tied = (albedo == p[:, None]).to(albedo.dtype)
    tiemask = tied / tied.sum(dim=-1, keepdim=True)
    one = torch.ones_like(albedo)
    inv_albedo = torch.where(albedo > 0, 1.0 / torch.where(albedo > 0, albedo, one),
                             torch.zeros_like(albedo))
    inv_p = torch.where(p > 0, 1.0 / torch.where(p > 0, p, torch.ones_like(p)),
                        torch.zeros_like(p))
    return cq * inv_albedo - (rr_w * inv_p)[:, None] * tiemask


def grads_from_partials(albedo, partials):
    """``{'albedo','emission','background'}`` from a ``[7N+6]`` partials
    vector (module docstring layout), in the partials' dtype."""
    n = albedo.shape[0]
    b = {k: partials[sl] for k, sl in partial_blocks(n).items()}
    return {"albedo": assemble_albedo_grad(albedo.to(partials.dtype), b["cq"].reshape(n, 3),
                                           b["rr_w"]),
            "emission": b["ge"].reshape(n, 3),
            "background": b["gbg"].reshape(2, 3)}


def replay_items(spheres, origins, directions, keys, ct, *, max_depth, rr_depth, epsilon,
                 inf, acc_dtype):
    """Replay a batch of paths from their camera rays and accumulate the
    ``[7N+6]`` partials in ``acc_dtype``.

    ``spheres`` needs the sphere fields plus ``background`` and ``ior``;
    ``keys`` are the paths' item keys; ``ct`` [B,3] their cotangents.  The
    bounce math runs in the rays' dtype, so its decisions are those of the
    render in that dtype.  Returns (partials, {'segments', 'depth'}) as in
    ``ops/integrator.radiance``, and 'prefix_terms': the (segment, sphere)
    pairs with a non-zero prefix counter, the only ones whose ``cnt * q``
    term is not zero (what the accumulation has to do on this data)."""
    dt = origins.dtype
    n = spheres.albedo.shape[0]
    sphere_ids = torch.arange(n, device=origins.device)
    ctd = ct.to(dt)
    cnt = torch.zeros((origins.shape[0], n), dtype=acc_dtype, device=origins.device)
    cnt_rr = torch.zeros_like(cnt)
    cq = torch.zeros((n, 3), dtype=acc_dtype, device=origins.device)
    rr_w = torch.zeros(n, dtype=acc_dtype, device=origins.device)
    ge = torch.zeros_like(cq)
    gbg = torch.zeros((2, 3), dtype=acc_dtype, device=origins.device)
    kw = dict(rr_depth=rr_depth, epsilon=epsilon, inf=inf)
    st = init_state(origins, directions)
    segments = depth = 0
    prefix_terms = torch.zeros((), dtype=torch.int64, device=origins.device)
    while depth < max_depth:
        live = int(st.alive.sum())
        if live == 0:
            break
        segments += live
        u = rng_ops.bounce_uniforms(keys[0], keys[1], depth).to(dt)
        st, aux = bounce_step(spheres, st, u, depth, with_aux=True, **kw)
        prefix_terms += ((cnt != 0) & aux["was_alive"][:, None]).sum()

        hit = aux["was_alive"] & aux["hit"]
        onehot = ((aux["hid"][:, None] == sphere_ids[None, :]) & hit[:, None]).to(acc_dtype)
        thr_ct = (ctd * aux["thr_pre"]).to(acc_dtype)  # the product in the bounce dtype
        ge += onehot.T @ thr_ct
        # This bounce's contribution: emission pickup on a hit, sky on a miss.
        q = (thr_ct * aux["em_h"].to(acc_dtype)) * hit[:, None].to(acc_dtype)
        miss = aux["die_miss"][:, None]
        q = q + torch.where(miss, thr_ct * aux["sky"].to(acc_dtype), torch.zeros_like(q))
        cq += cnt.T @ q
        rr_w += cnt_rr.T @ q.sum(dim=-1)
        sky_t = aux["sky_t"].to(acc_dtype)[:, None]
        gbg[0] += torch.where(miss, (1.0 - sky_t) * thr_ct, torch.zeros_like(q)).sum(dim=0)
        gbg[1] += torch.where(miss, sky_t * thr_ct, torch.zeros_like(q)).sum(dim=0)
        # Counters after the accumulation: f_k multiplies later bounces only.
        inc = onehot * aux["cont"][:, None].to(acc_dtype)
        cnt += inc
        cnt_rr += inc * aux["rr_scaled"][:, None].to(acc_dtype)
        depth += 1
    partials = torch.cat([cq.reshape(-1), rr_w, ge.reshape(-1), gbg.reshape(-1)])
    return partials, {"segments": segments, "depth": depth, "prefix_terms": int(prefix_terms)}


def replay_param_grads(scene, cfg, cell_ids, sample_start: int, num_samples: int, ct):
    """Gradients of ``sum(ct * render_cells_range(scene, cfg, cell_ids,
    sample_start, num_samples))`` with respect to albedo, emission and
    background: one batch of the cells per sample, accumulated in the
    scene's dtype (the float64 oracle).

    Args:
      cell_ids: any id set, a tensor or a host ``range``.
      ct: [B,3] per-cell cotangent (B == len(cell_ids)).
    Returns ``{'albedo': [N,3], 'emission': [N,3], 'background': [2,3]}``.
    """
    from ..render import camera_rays  # render imports the kernels

    cell_ids = cell_ids_of(cell_ids, scene.device)
    dt = scene.dtype
    total = None
    for i in range(num_samples):
        keys, o, d = camera_rays(scene, cfg, cell_ids, sample_start + i, dt)
        part, _ = replay_items(scene, o, d, keys, ct, max_depth=cfg.max_depth,
                               rr_depth=cfg.rr_depth, epsilon=cfg.epsilon, inf=cfg.inf,
                               acc_dtype=dt)
        total = part if total is None else total + part
    return grads_from_partials(scene.albedo, total)


def replay_route(scene, cfg) -> str:
    """The replay a backward runs, chosen from the scene and config before
    anything launches (JAX ``ops/replay.py:77-84``): 'kernel' for a CUDA
    scene the replay kernel takes (``ops/kernels/replay.replay_kernel_takes``)
    and for any other device but the CPU (whose kernel entry launches or
    raises); 'plain' (``replay_param_grads``, on the scene's device) for a
    scene on the CPU and for a CUDA scene in float64, with tent jitter or
    with more than MAX_REPLAY_SPHERES spheres."""
    from .kernels.replay import replay_kernel_takes

    if scene.device.type == "cpu":
        return "plain"
    if scene.device.type == "cuda" and not replay_kernel_takes(cfg, scene.dtype,
                                                               scene.num_spheres):
        return "plain"
    return "kernel"


def replay_param_grads_auto(scene, cfg, cell_ids, sample_start: int, num_samples: int, ct):
    """The production replay, on the scene's device, by ``replay_route``:
    the batch replay above, or the kernel's gradient entry
    (``ops/kernels/replay.replay_param_grads_kernel``, which on CUDA
    launches the kernel or raises)."""
    if replay_route(scene, cfg) == "plain":
        return replay_param_grads(scene, cfg, cell_ids, sample_start, num_samples, ct)
    from .kernels.replay import replay_param_grads_kernel

    return replay_param_grads_kernel(scene, cfg, cell_ids, sample_start, num_samples, ct)
