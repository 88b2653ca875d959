"""The path estimator: intersection, materials and the bounce loop.

A batch of rays advances one bounce a step (``src/main.cpp:104-158``):
emission is picked up at every hit; a miss adds the throughput times the
sky lerp ``t = 0.5*(unit_dir.y + 1)`` and ends the path; after depth
``rr_depth`` Russian roulette survives with ``p = max(albedo)``, uncapped,
and divides the throughput by ``p``; the hit material scatters (cosine
diffuse, mirror, Schlick dielectric with index 2.0); the depth limit
returns the emission picked up so far.  Every dot product is the
left-associated chain ``x0*y0 + x1*y1 + x2*y2`` and every reciprocal a
correctly rounded divide of a correctly rounded square root, the form in
which the estimator is stated, so that a float32 implementation of it
rounds alike term for term.  Discrete decisions (hit ids, roulette, the
dielectric's choice, the diffuse frame's axis) are piecewise constant:
under autograd the gradients flow through everything else.

``trace`` keeps only live rays in the batch from bounce to bounce (a
gather by index after each bounce, which changes no ray's arithmetic) and
can count, beside the radiance, the work a path's inputs need: segments,
the (segment, sphere) pairs whose prefix hit counter is non-zero, paths
that end on a miss with the bounces before their miss, and those bounces
whose nearest root tied with another sphere's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng


def rsqrt(x):
    return 1.0 / torch.sqrt(torch.where(x > 0, x, torch.ones_like(x)))


def _sqrt0(x):
    return torch.sqrt(torch.maximum(x, x.new_zeros(())))


def sphere_roots(scene, o, d, epsilon, inf):
    """[B,N]: each sphere's nearest root >= epsilon, ``inf`` where none."""
    r = scene.radius[None, :]
    p0, ad = scene.p0, scene.anchor_dir
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    qx, qy, qz = ox - p0[None, :, 0], oy - p0[None, :, 1], oz - p0[None, :, 2]
    adx, ady, adz = ad[None, :, 0], ad[None, :, 1], ad[None, :, 2]
    a = dx * dx + dy * dy + dz * dz
    qd = qx * dx + qy * dy + qz * dz
    add = adx * dx + ady * dy + adz * dz
    b = qd + r * add
    qq = qx * qx + qy * qy + qz * qz
    qad = qx * adx + qy * ady + qz * adz
    c = qq + 2.0 * r * qad
    disc = b * b - a * c
    has_root = disc >= 0.0
    tangent = disc == 0.0
    sqrtd = torch.where(tangent, torch.zeros_like(disc),
                        torch.sqrt(torch.where(has_root & ~tangent, disc, torch.ones_like(disc))))
    sign_b = torch.where(b >= 0.0, 1.0, -1.0).to(b.dtype)
    qform = -(b + sign_b * sqrtd)
    nonzero = qform != 0.0
    root_1 = qform * (1.0 / a)
    root_2 = torch.where(nonzero, c / torch.where(nonzero, qform, torch.ones_like(qform)),
                         torch.full_like(qform, inf))
    t_near = torch.minimum(root_1, root_2)
    t_far = torch.maximum(root_1, root_2)
    inf_t = torch.full_like(t_near, inf)
    root = torch.where(t_near >= epsilon, t_near, torch.where(t_far >= epsilon, t_far, inf_t))
    return torch.where(has_root, root, inf_t)


def _diffuse(nx, ny, nz, u_phi, u_sin2):
    phi = (2.0 * math.pi) * u_phi
    sin_t = torch.sqrt(u_sin2)
    cos_t = _sqrt0(1.0 - u_sin2)
    ax_y = torch.abs(nx) > 0.1
    zero = torch.zeros_like(nz)
    ux_r = torch.where(ax_y, nz, zero)
    uy_r = torch.where(ax_y, zero, -nz)
    uz_r = torch.where(ax_y, -nx, ny)
    uinv = rsqrt(ux_r * ux_r + uy_r * uy_r + uz_r * uz_r)
    ux, uy, uz = ux_r * uinv, uy_r * uinv, uz_r * uinv
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    cp, sp = torch.cos(phi), torch.sin(phi)
    ddx = ux * cp * sin_t + vx * sp * sin_t + nx * cos_t
    ddy = uy * cp * sin_t + vy * sp * sin_t + ny * cos_t
    ddz = uz * cp * sin_t + vz * sp * sin_t + nz * cos_t
    dinv = rsqrt(ddx * ddx + ddy * ddy + ddz * ddz)
    return ddx * dinv, ddy * dinv, ddz * dinv


def _dielectric(dx, dy, dz, a_quad, nx, ny, nz, front, u_choice, ior, spx, spy, spz):
    ratio = torch.where(front, float(np.float32(1.0 / ior)), float(np.float32(ior))).to(dx.dtype)
    dinv = rsqrt(a_quad)
    udx, udy, udz = dx * dinv, dy * dinv, dz * dinv
    cos_d = torch.minimum(-(udx * nx + udy * ny + udz * nz), dx.new_ones(()))
    sin_d = _sqrt0(1.0 - cos_d * cos_d)
    cannot = ratio * sin_d > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    mm = torch.maximum(1.0 - cos_d, dx.new_zeros(()))
    reflected = cannot | (r0 + (1.0 - r0) * (mm * mm * mm * mm * mm) > u_choice)
    ppx = (udx + nx * cos_d) * ratio
    ppy = (udy + ny * cos_d) * ratio
    ppz = (udz + nz * cos_d) * ratio
    kk = torch.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz))
    zero_k = kk == 0.0
    neg_sqrt_k = -torch.where(zero_k, torch.zeros_like(kk), torch.sqrt(torch.where(zero_k, 1.0, kk)))
    return (torch.where(reflected, spx, ppx + nx * neg_sqrt_k),
            torch.where(reflected, spy, ppy + ny * neg_sqrt_k),
            torch.where(reflected, spz, ppz + nz * neg_sqrt_k))


def _scatter(mat, d, n_out, normal, front, u_a, u_b, ior):
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    nox, noy, noz = n_out[:, 0], n_out[:, 1], n_out[:, 2]
    nx, ny, nz = normal[:, 0], normal[:, 1], normal[:, 2]
    a_quad = dx * dx + dy * dy + dz * dz
    ddx, ddy, ddz = _diffuse(nx, ny, nz, u_a, u_b)
    ndotd = nox * dx + noy * dy + noz * dz
    spx, spy, spz = dx - 2.0 * nox * ndotd, dy - 2.0 * noy * ndotd, dz - 2.0 * noz * ndotd
    dlx, dly, dlz = _dielectric(dx, dy, dz, a_quad, nx, ny, nz, front, u_a, ior, spx, spy, spz)
    m_dif, m_spe, m_die = mat[:, 0], mat[:, 1], mat[:, 2]
    return torch.stack([m_dif * ddx + m_spe * spx + m_die * dlx,
                        m_dif * ddy + m_spe * spy + m_die * dly,
                        m_dif * ddz + m_spe * spz + m_die * dlz], dim=-1)


class _Rows(torch.autograd.Function):
    """``table[idx]``, whose backward adds each row's gradient as a one-hot
    product in float64: no atomic adds, whose float32 sums over millions of
    rays onto a few rows would round far more than the product does."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(idx, ctx.rows).to(torch.float64)
        return (onehot.T @ g.to(torch.float64)).to(g.dtype), None


def bounce(scene, o, d, thr, emit, u, depth: int, rr_depth: int, epsilon, inf, ties=False):
    """One bounce of a batch of live rays.  Returns (origin, direction,
    throughput, emission, alive after it, the radiance of the rays it ended,
    the rays that missed, the hit ids, and with ``ties`` each ray's count
    of spheres whose root equals its nearest)."""
    u_rr, u_a, u_b = u[:, 0], u[:, 1], u[:, 2]
    roots = sphere_roots(scene, o, d, epsilon, inf)
    t = roots.amin(dim=-1)
    hid = roots.argmin(dim=-1)
    hit = t < inf
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    sky_t = (dy * rsqrt(dx * dx + dy * dy + dz * dz)) * 0.5 + 0.5
    bg = scene.background.to(o.dtype)
    sky = bg[0] + sky_t[:, None] * (bg[1] - bg[0])
    miss = ~hit
    result = torch.where(miss[:, None], emit + thr * sky, torch.zeros_like(emit))

    t_safe = torch.where(hit, t, torch.ones_like(t))
    center = scene.p0 - scene.radius[:, None] * scene.anchor_dir
    rows = _Rows.apply(torch.cat([center, scene.emission, scene.albedo], dim=1), hid)
    mat = torch.nn.functional.one_hot(scene.material.long(), 3).to(o.dtype)[hid]
    hx = o[:, 0] + t_safe * dx
    hy = o[:, 1] + t_safe * dy
    hz = o[:, 2] + t_safe * dz
    nrx, nry, nrz = hx - rows[:, 0], hy - rows[:, 1], hz - rows[:, 2]
    ninv = rsqrt(nrx * nrx + nry * nry + nrz * nrz)
    nox, noy, noz = nrx * ninv, nry * ninv, nrz * ninv
    front = nox * dx + noy * dy + noz * dz < 0.0
    fsign = torch.where(front, 1.0, -1.0).to(o.dtype)
    n_out = torch.stack([nox, noy, noz], dim=-1)
    em_h, al_h = rows[:, 3:6], rows[:, 6:9]
    emit_new = emit + thr * em_h

    p = al_h.amax(dim=-1)
    p_inv = 1.0 / torch.where(p > 0, p, torch.ones_like(p))
    do_rr = depth > rr_depth
    survive = u_rr < p
    killed = survive.logical_not() if do_rr else torch.zeros_like(survive)
    result = torch.where((hit & killed)[:, None], emit_new, result)
    colf = torch.where(survive, p_inv, torch.ones_like(p_inv)) if do_rr else torch.ones_like(p_inv)
    thr_new = thr * al_h * colf[:, None]
    d_new = _scatter(mat, d, n_out, n_out * fsign[:, None], front, u_a, u_b, scene.ior)
    hp = torch.stack([hx, hy, hz], dim=-1)
    cont = hit & ~killed
    n_ties = (roots == t[:, None]).sum(dim=-1) if ties else None
    return hp, d_new, thr_new, emit_new, cont, result, miss, hid, n_ties


def trace(scene, o, d, keys, *, max_depth: int, rr_depth: int, epsilon, inf, count=False):
    """Radiance [B,3] of a batch of camera rays with their item keys, and
    with ``count`` the work counts of the module docstring (Python ints)."""
    dtype, dev = o.dtype, o.device
    n = o.shape[0]
    n_sph = scene.radius.shape[0]
    grad = torch.is_grad_enabled()
    out = torch.zeros((n, 3), dtype=dtype, device=dev)
    idx = torch.arange(n, device=dev)
    thr, emit = torch.ones_like(o), torch.zeros_like(o)
    k0, k1 = keys
    counts = dict(segments=0, prefix_terms=0, missed=0, sweep_bounces=0, tied_bounces=0)
    if count:
        seen = torch.zeros((n, n_sph), dtype=torch.bool, device=dev)
        tied = torch.zeros(n, dtype=torch.int64, device=dev)
        totals = torch.zeros(4, dtype=torch.int64, device=dev)

    def put(out, rows, vals):
        return out.index_put((rows,), vals) if grad else out.index_put_((rows,), vals)

    for depth in range(max_depth):
        live = idx.shape[0]
        if live == 0:
            break
        counts["segments"] += live
        u = rng.bounce_uniforms(k0, k1, depth).to(dtype)
        o, d, thr, emit, alive, result, miss, hid, n_ties = bounce(
            scene, o, d, thr, emit, u, depth, rr_depth, epsilon, inf, ties=count)
        if count:
            totals[0] += seen.sum()
            hit_tied = (~miss) & (n_ties > 1)
            totals[1] += miss.sum()
            totals[2] += miss.sum() * depth
            totals[3] += torch.where(miss, tied, torch.zeros_like(tied)).sum()
            tied = tied + hit_tied.to(torch.int64)
            seen = seen | (torch.nn.functional.one_hot(hid, n_sph).bool() & alive[:, None])
        ended = ~alive
        if depth == max_depth - 1:
            out = put(out, idx, torch.where(ended[:, None], result, emit))
            break
        done = ended.nonzero().squeeze(1)
        if done.numel():
            out = put(out, idx[done], result[done])
        keep = alive.nonzero().squeeze(1)
        if keep.numel() < live:
            o, d, thr, emit, k0, k1, idx = (x[keep] for x in (o, d, thr, emit, k0, k1, idx))
            if count:
                seen, tied = seen[keep], tied[keep]
    if not count:
        return out
    for name, v in zip(("prefix_terms", "missed", "sweep_bounces", "tied_bounces"),
                       totals.tolist()):
        counts[name] = v
    return out, counts
