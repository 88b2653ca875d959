"""Geometry and camera backward by replay: hand-written adjoints of a path.

With the decisions held fixed (hit ids, the roulette, the dielectric's
reflect-or-refract lottery and the diffuse ONB's axis pick), the throughput
and the emission pickups of a path are products of albedo and emission
values picked by discrete ids (``ops/replay.py``).  Sphere positions, radii
and the camera reach a path's value only through the sky lerp of its
terminal miss direction: for a path that ends on a miss at bounce K,

    dL/dθ = (Σ_c ct_c · thr_K,c · (bg1_c − bg0_c)) · ∂sky_t/∂d_K · ∂d_K/∂θ,
    sky_t = 0.5 · d_y/|d| + 0.5,

so a path carries one scalar-weighted seed, at its end, and a path that the
roulette or the depth limit ends carries none.  The seed is swept back
through the path's bounces, newest first, by the hand-written VJP of each
piece of ``ops/integrator.bounce_step``:

* the sampler of the material that was hit (``sample_diffuse_c``,
  ``sample_specular_c``, ``sample_dielectric_c``; the one-hot blend of
  ``scatter`` gives the same value, its other terms being 0);
* the hit record (hp = o + t·d, the outward normal through the center
  p0 − r·anchor_dir and ``rsqrt_safe``, the front-facing sign);
* the hit sphere's root t in the anchor form (the stable q-root of
  b² − a·c), with the torch.minimum / maximum tie split of a double root;

which adds the hit sphere's p0 and radius terms, and ends in the VJP of the
primary ray (``models/camera.get_rays``: the lens disk and origin_advance).
The guards of the scan VJP are kept: a tangent ray (disc == 0) and a tangent
refraction (kk == 0) take a zero derivative there.  Where m spheres' roots
tie exactly at t, t's adjoint goes g_t / m to each of them through its own
root, as ``amin`` (and ``jnp.min``) split it; the hit record and the normal
stay the hit sphere's (the lowest index), as the forward's.

The sums are kept as one vector of ``4N+14`` partials, the layout of the
CUDA kernel (``ops/kernels/geometry_replay.py``):

    [0:3N)       p0, sphere-major
    [3N:4N)      radius
    [4N:4N+14)   the camera floats of ``pack_camera``: position(3)
                 lower_left(3) cam_x(3) cam_y(3) lens_radius(1)
                 origin_advance(1)

``geometry_grads_from_partials`` maps the camera partials to the eight
``CameraConfig`` leaves by autograd through ``build_camera``.  Background is
not among the partials: the replay of ``ops/replay.py`` gives it.

Every forward value the adjoints read is recomputed in the rays' dtype by
the render's own expressions, so its decisions are the render's; the
adjoint arithmetic runs in ``acc_dtype``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import rng as rng_ops
from .integrator import bounce_step, init_state
from .intersect import rsqrt_safe, sphere_roots

# The camera floats the partials hold (module docstring): position(3)
# lower_left(3) cam_x(3) cam_y(3) lens_radius origin_advance.
N_CAMERA_PARTIALS = 14


def n_geometry_partials(n_spheres: int) -> int:
    return 4 * n_spheres + N_CAMERA_PARTIALS


def geometry_partial_blocks(n_spheres: int) -> dict:
    """The three blocks of the partials vector (module docstring), as slices."""
    n = n_spheres
    return {"p0": slice(0, 3 * n), "radius": slice(3 * n, 4 * n),
            "camera": slice(4 * n, 4 * n + N_CAMERA_PARTIALS)}


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def _col(x):
    return x[:, None]


def _normalize_vjp(x, inv, g):
    """VJP of y = x · inv, inv = 1/sqrt(x·x) (``rsqrt_safe`` of a positive
    length)."""
    return g * _col(inv) - x * _col(_dot(g, x) * inv * inv * inv)


# ---- forward recompute (the rays' dtype: the render's expressions) --------

def root_forward(o, d, p0, ad, r, *, epsilon, inf):
    """``intersect_scene``'s quadratic and root choice for one sphere a ray
    (p0, ad [B,3], r [B]), with the weights of r1 and r2 in t (w1, w2:
    torch.minimum and torch.maximum split a double root's evenly)."""
    dt = o.dtype
    q = o - p0
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    qd = _dot(q, d)
    add = _dot(ad, d)
    b = qd + r * add
    qq = _dot(q, q)
    qad = _dot(q, ad)
    c = qq + 2.0 * r * qad
    disc = b * b - a * c
    tangent = disc == 0.0
    sqrtd = torch.where(tangent, torch.zeros_like(disc),
                        torch.sqrt(torch.where((disc >= 0.0) & ~tangent, disc,
                                               torch.ones_like(disc))))
    sign_b = torch.where(b >= 0.0, 1.0, -1.0).to(dt)
    qform = -(b + sign_b * sqrtd)
    a_inv = 1.0 / a
    r1 = qform * a_inv
    nonzero = qform != 0.0
    r2 = torch.where(nonzero, c / torch.where(nonzero, qform, torch.ones_like(qform)),
                     torch.full_like(qform, inf))
    near, far = torch.minimum(r1, r2), torch.maximum(r1, r2)
    use_near = near >= epsilon
    w1 = torch.where(r1 == r2, 0.5, torch.where(use_near, r1 < r2, r1 > r2).to(dt)).to(dt)
    return SimpleNamespace(d=d, ad=ad, r=r, q=q, a=a, add=add, b=b, qad=qad, c=c,
                           tangent=tangent, sqrtd=sqrtd, sign_b=sign_b, qform=qform,
                           a_inv=a_inv, w1=w1, w2=torch.where(r1 == r2, 0.5, 1.0 - w1).to(dt),
                           t=torch.where(use_near, near, far))


def diffuse_forward(n, u_a, u_b):
    """``sample_diffuse_c``'s frame and direction about the normal ``n``."""
    sin_t = torch.sqrt(u_b)
    cos_t = torch.sqrt(torch.maximum(1.0 - u_b, u_b.new_zeros(())))
    phi = (2.0 * torch.pi) * u_a
    cp, sp = torch.cos(phi), torch.sin(phi)
    ax_y = torch.abs(n[:, 0]) > 0.1
    zero = torch.zeros_like(n[:, 2])
    u_r = torch.stack([torch.where(ax_y, n[:, 2], zero), torch.where(ax_y, zero, -n[:, 2]),
                       torch.where(ax_y, -n[:, 0], n[:, 1])], dim=-1)
    uinv = rsqrt_safe(_dot(u_r, u_r))
    uu = u_r * _col(uinv)
    vv = _cross(n, uu)
    dd = uu * _col(cp) * _col(sin_t) + vv * _col(sp) * _col(sin_t) + n * _col(cos_t)
    return SimpleNamespace(n=n, sin_t=sin_t, cos_t=cos_t, cp=cp, sp=sp, ax_y=ax_y, u_r=u_r,
                           uinv=uinv, uu=uu, vv=vv, dd=dd, dinv2=rsqrt_safe(_dot(dd, dd)))


def dielectric_forward(d, n, front, u_a, ior):
    """``sample_dielectric_c``'s lottery (``reflected``) and refraction
    about the front-facing normal ``n``."""
    ratio = torch.where(front, float(np.float32(1.0 / ior)), float(np.float32(ior))).to(d.dtype)
    dinv = rsqrt_safe(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    ud = d * _col(dinv)
    y = -(ud[:, 0] * n[:, 0] + ud[:, 1] * n[:, 1] + ud[:, 2] * n[:, 2])
    cos_d = torch.minimum(y, y.new_ones(()))
    sin_d = torch.sqrt(torch.maximum(1.0 - cos_d * cos_d, y.new_zeros(())))
    cannot = ratio * sin_d > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    mm = torch.maximum(1.0 - cos_d, y.new_zeros(()))
    reflected = cannot | (r0 + (1.0 - r0) * (mm * mm * mm * mm * mm) > u_a)
    pp = (ud + n * _col(cos_d)) * _col(ratio)
    x = 1.0 - (pp[:, 0] * pp[:, 0] + pp[:, 1] * pp[:, 1] + pp[:, 2] * pp[:, 2])
    kk = torch.abs(x)
    zero_k = kk == 0.0
    sqrt_k = torch.where(zero_k, torch.zeros_like(kk), torch.sqrt(torch.where(zero_k, 1.0, kk)))
    return SimpleNamespace(d=d, n=n, ratio=ratio, dinv=dinv, ud=ud, y=y, cos_d=cos_d,
                           reflected=reflected, pp=pp, x=x, zero_k=zero_k, sqrt_k=sqrt_k)


def bounce_forward(spheres, o, d, hid, u, *, epsilon, inf):
    """The values of one hit bounce that its adjoint reads, recomputed for
    the hit sphere ``hid`` by the expressions of ``intersect_scene``,
    ``hit_record`` and ``scatter``, in the rays' dtype.  ``u`` [B,4] are the
    bounce's uniforms (``ops/rng.bounce_uniforms``).  Returns a namespace of
    tensors (the hit's, and ``root``, ``diffuse``, ``dielectric``, and
    ``tied`` [B,N], the spheres whose root equals t, with their count
    ``ties``); ``cast_forward`` takes its floats to the adjoint's dtype."""
    dt = o.dtype
    p0, ad, r = spheres.p0[hid].to(dt), spheres.anchor_dir[hid].to(dt), spheres.radius[hid].to(dt)
    root = root_forward(o, d, p0, ad, r, epsilon=epsilon, inf=inf)
    roots = sphere_roots(spheres, o, d, epsilon=epsilon, inf=inf)
    tied = roots == roots.gather(1, hid[:, None])
    center = p0 - _col(r) * ad
    nr = o + _col(root.t) * d - center
    ninv = rsqrt_safe(_dot(nr, nr))
    no = nr * _col(ninv)
    front = _dot(no, d) < 0.0
    fsign = torch.where(front, 1.0, -1.0).to(dt)
    n = no * _col(fsign)
    u_a, u_b = u[:, 1].to(dt), u[:, 2].to(dt)
    return SimpleNamespace(d=d, t=root.t, ad=ad, nr=nr, ninv=ninv, no=no, fsign=fsign,
                           mat=spheres.material[hid].long(), root=root, hid=hid, tied=tied,
                           ties=tied.sum(dim=1),
                           diffuse=diffuse_forward(n, u_a, u_b),
                           dielectric=dielectric_forward(d, n, front, u_a, spheres.ior))


def cast_forward(fw, dtype):
    """``fw`` with its float tensors in ``dtype`` (decisions unchanged)."""
    def cast(v):
        if isinstance(v, SimpleNamespace):
            return cast_forward(v, dtype)
        return v.to(dtype) if torch.is_floating_point(v) else v

    return SimpleNamespace(**{k: cast(v) for k, v in vars(fw).items()})


# ---- the hand-written VJPs (the adjoint's dtype) ---------------------------

def root_vjp(f, g_t):
    """VJP of the hit sphere's root t (``intersect_scene``'s anchor form).
    Returns (g_q, g_d, g_r): q = o − p0, so g_o = g_q and g_p0 = −g_q."""
    g_r1, g_r2 = g_t * f.w1, g_t * f.w2
    nonzero = f.qform != 0.0
    qf = torch.where(nonzero, f.qform, torch.ones_like(f.qform))
    g_qform = g_r1 * f.a_inv - torch.where(nonzero, g_r2 * f.c / (qf * qf), 0.0)
    g_c = torch.where(nonzero, g_r2 / qf, 0.0)
    g_a = -(g_r1 * f.qform) * f.a_inv * f.a_inv
    g_b = -g_qform
    # A tangent ray's sqrt takes a zero derivative (the scan VJP's guard).
    sq = torch.where(f.tangent, torch.ones_like(f.sqrtd), f.sqrtd)
    g_disc = torch.where(f.tangent, 0.0, -f.sign_b * g_qform * 0.5 / sq)
    g_b = g_b + 2.0 * f.b * g_disc
    g_a = g_a - f.c * g_disc
    g_c = g_c - f.a * g_disc
    g_r = g_b * f.add + 2.0 * f.qad * g_c
    g_q = _col(g_b) * f.d + _col(2.0 * g_c) * f.q + _col(2.0 * f.r * g_c) * f.ad
    g_d = _col(g_b) * f.q + _col(g_b * f.r) * f.ad + _col(2.0 * g_a) * f.d
    return g_q, g_d, g_r


def hit_record_vjp(f, g_hp, g_no):
    """VJP of ``hit_record`` for the adjoints of the hit point and the
    outward normal (the front-facing normal's folded in by the caller).
    Returns (g_o, g_d, g_t, g_center)."""
    g_nr = _normalize_vjp(f.nr, f.ninv, g_no)
    g_hp = g_hp + g_nr
    return g_hp, _col(f.t) * g_hp, _dot(g_hp, f.d), -g_nr


def specular_vjp(d, no, g):
    """VJP of ``sample_specular_c``: (g_d, g_no)."""
    s = _dot(no, d)
    g_s = -2.0 * _dot(no, g)
    return g + _col(g_s) * no, -2.0 * _col(s) * g + _col(g_s) * d


def diffuse_vjp(f, g):
    """VJP of ``sample_diffuse_c`` with respect to the front-facing normal."""
    g_dd = _normalize_vjp(f.dd, f.dinv2, g)
    g_u = g_dd * _col(f.cp * f.sin_t)
    g_v = g_dd * _col(f.sp * f.sin_t)
    g_n = g_dd * _col(f.cos_t) + _cross(f.uu, g_v)
    g_u = g_u + _cross(g_v, f.n)
    g_ur = _normalize_vjp(f.u_r, f.uinv, g_u)
    zero = torch.zeros_like(g_ur[:, 0])
    ax_y = f.ax_y
    # u_r = (n_z, 0, -n_x) when |n_x| > 0.1, else (0, -n_z, n_y)
    g_n = g_n + torch.stack([torch.where(ax_y, -g_ur[:, 2], zero),
                             torch.where(ax_y, zero, g_ur[:, 2]),
                             torch.where(ax_y, g_ur[:, 0], -g_ur[:, 1])], dim=-1)
    return g_n


def refract_vjp(f, g):
    """VJP of ``sample_dielectric_c``'s refraction: (g_d, g_n)."""
    g_n = g * _col(-f.sqrt_k)
    g_nsk = _dot(g, f.n)
    # kk == 0 (a tangent refraction) takes a zero derivative (the scan VJP's guard).
    sk = torch.where(f.zero_k, torch.ones_like(f.sqrt_k), f.sqrt_k)
    g_kk = torch.where(f.zero_k, 0.0, -g_nsk * 0.5 / sk)
    g_x = g_kk * torch.sign(f.x)
    g_pp = g - 2.0 * _col(g_x) * f.pp
    g_ud = g_pp * _col(f.ratio)
    g_n = g_n + g_ud * _col(f.cos_d)
    g_cos = _dot(g_ud, f.n)
    # cos_d = minimum(y, 1): y's share, half of it on a tie.
    g_y = g_cos * torch.where(f.y < 1.0, 1.0, torch.where(f.y == 1.0, 0.5, 0.0))
    g_ud = g_ud - _col(g_y) * f.n
    g_n = g_n - _col(g_y) * f.ud
    return _normalize_vjp(f.d, f.dinv, g_ud), g_n


def bounce_vjp(f, go, gd):
    """VJP of one hit bounce, (o, d, p0[h], r[h]) -> (hit point, new
    direction), for the adjoints ``go``, ``gd`` of its outputs.  ``f`` is
    ``bounce_forward``'s namespace in the adjoint's dtype.  Only the sampler
    of the material that was hit is differentiated.  The hit sphere's root
    takes its share of t's adjoint, g_t / ``f.ties``.  Returns (g_o, g_d,
    g_p0 [B,3], g_r [B], g_share [B]): a ray whose root ties with other
    spheres' passes g_share to ``tie_vjp``."""
    zero = torch.zeros_like(gd)
    spec_d, spec_no = specular_vjp(f.d, f.no, gd)
    refr_d, refr_n = refract_vjp(f.dielectric, gd)
    diff_n = diffuse_vjp(f.diffuse, gd)
    diffuse, dielectric = _col(f.mat == 0), _col(f.mat == 2)
    refracted = dielectric & ~_col(f.dielectric.reflected)
    g_n = torch.where(diffuse, diff_n, torch.where(refracted, refr_n, zero))
    g_d = torch.where(diffuse, zero, torch.where(refracted, refr_d, spec_d))
    g_no = torch.where(diffuse | refracted, zero, spec_no) + g_n * _col(f.fsign)
    g_o, g_d_hit, g_t, g_center = hit_record_vjp(f, go, g_no)
    g_share = g_t / f.ties.to(g_t.dtype)
    g_q, g_d_root, g_r = root_vjp(f.root, g_share)
    return (g_o + g_q, g_d + g_d_hit + g_d_root, g_center - g_q,
            g_r - _dot(g_center, f.ad), g_share)


def tie_vjp(spheres, o, d, f, g_share, *, epsilon, inf):
    """The root VJPs of the spheres that tie with a ray's hit sphere (``f``
    from ``bounce_forward``; rays ``o``, ``d`` in their dtype): each takes
    ``g_share`` through its own root, recomputed in the rays' dtype.
    Returns (g_o, g_d [B,3], g_sphere [N,4]: p0 xyz and radius summed over
    the rays), in ``g_share``'s dtype."""
    acc, n = g_share.dtype, f.tied.shape[1]
    g_o = torch.zeros(o.shape, dtype=acc, device=o.device)
    g_d = torch.zeros_like(g_o)
    g_sphere = torch.zeros((n, 4), dtype=acc, device=o.device)
    hit = torch.zeros_like(f.tied)
    hit[torch.arange(f.tied.shape[0], device=o.device), f.hid] = True
    ray, j = torch.nonzero(f.tied & ~hit, as_tuple=True)
    if ray.numel():
        dt = o.dtype
        rf = root_forward(o[ray], d[ray], spheres.p0[j].to(dt), spheres.anchor_dir[j].to(dt),
                          spheres.radius[j].to(dt), epsilon=epsilon, inf=inf)
        g_q, g_d_root, g_r = root_vjp(cast_forward(rf, acc), g_share[ray])
        g_o.index_add_(0, ray, g_q)
        g_d.index_add_(0, ray, g_d_root)
        g_sphere.index_add_(0, j, torch.cat([-g_q, _col(g_r)], dim=1))
    return g_o, g_d, g_sphere


def miss_seed(d, w):
    """The adjoint of a miss direction ``d`` [B,3] for the weight ``w`` [B]
    = Σ_c ct_c · thr_c · (bg1_c − bg0_c): w · ∂sky_t/∂d."""
    dinv = rsqrt_safe(_dot(d, d))
    h = 0.5 * w * dinv
    g = -_col(h * d[:, 1] * dinv * dinv) * d
    return g + torch.stack([torch.zeros_like(h), h, torch.zeros_like(h)], dim=-1)


def camera_vjp(camera, s, t, u_disk1, u_disk2, d0, g_o, g_d):
    """VJP of ``models/camera.get_rays`` with respect to the packed camera
    floats, per ray: [B, 14] in the partials' order.  ``d0`` is the
    primary direction; every tensor in the adjoint's dtype."""
    adv = camera.origin_advance.to(g_o.dtype)
    g_dir = g_d + adv * g_o
    st = s + t
    g_off = g_o - g_dir
    theta = (2.0 * torch.pi) * u_disk2
    g_rad = st * (torch.cos(theta) * g_off[:, 0] + torch.sin(theta) * g_off[:, 1])
    return torch.cat([g_o - g_dir, g_dir, g_dir * _col(s), g_dir * _col(t),
                      _col(g_rad * torch.sqrt(u_disk1)), _col(_dot(g_o, d0))], dim=1)


# ---- the batch replay -------------------------------------------------------

def geometry_items(spheres, camera, origins, directions, keys, screen, ct, *, max_depth,
                   rr_depth, epsilon, inf, acc_dtype):
    """Replay a batch of paths from their camera rays and accumulate the
    ``[4N+14]`` partials in ``acc_dtype``.

    ``spheres`` needs the sphere fields plus ``background`` and ``ior``;
    ``camera`` is the ``Camera`` the rays came from, ``screen`` = (s, t,
    u [B,4]) their screen coordinates and camera uniforms; ``keys`` the
    paths' item keys; ``ct`` [B,3] their cotangents.  The forward is
    ``bounce_step`` in the rays' dtype, recording each bounce's input ray
    and hit id; the sweep runs for the paths that ended on a miss.  Returns
    (partials, {'segments', 'depth', 'missed', 'sweep_bounces',
    'tied_bounces'}): 'sweep_bounces' is the bounces the sweep went back
    through (a missed path's segments less its miss), 'tied_bounces' those
    of them whose hit sphere's root tied with another's."""
    dt, dev, acc = origins.dtype, origins.device, acc_dtype
    n = spheres.radius.shape[0]
    kw = dict(rr_depth=rr_depth, epsilon=epsilon, inf=inf)
    bg = spheres.background.to(dt)
    dbg = (bg[1] - bg[0]).to(acc)
    ctd = ct.to(dt)
    st = init_state(origins, directions)
    rec_o, rec_d, rec_h = [], [], []
    miss_at = torch.full((origins.shape[0],), -1, dtype=torch.int64, device=dev)
    seed = torch.zeros(origins.shape, dtype=acc, device=dev)
    segments = depth = 0
    while depth < max_depth:
        live = int(st.alive.sum())
        if live == 0:
            break
        segments += live
        u = rng_ops.bounce_uniforms(keys[0], keys[1], depth).to(dt)
        rec_o.append(st.origin)
        rec_d.append(st.direction)
        new, aux = bounce_step(spheres, st, u, depth, with_aux=True, **kw)
        rec_h.append(aux["hid"])
        miss = aux["die_miss"]
        if bool(miss.any()):
            w = ((ctd[miss] * aux["thr_pre"][miss]).to(acc) * dbg).sum(dim=-1)
            seed[miss] = miss_seed(st.direction[miss].to(acc), w)
            miss_at[miss] = depth
        st = new
        depth += 1

    go = torch.zeros(origins.shape, dtype=acc, device=dev)
    gd = torch.zeros_like(go)
    gp = torch.zeros((n, 4), dtype=acc, device=dev)  # p0 xyz, radius
    sphere_ids = torch.arange(n, device=dev)
    tied_bounces = 0
    for k in range(depth - 1, -1, -1):
        at = miss_at == k
        gd = torch.where(_col(at), seed, gd)
        idx = torch.nonzero(miss_at > k).squeeze(1)
        if not idx.numel():
            continue
        u = rng_ops.bounce_uniforms(keys[0][idx], keys[1][idx], k)
        hid = rec_h[k][idx]
        o_k, d_k = rec_o[k][idx], rec_d[k][idx]
        fw = bounce_forward(spheres, o_k, d_k, hid, u, epsilon=epsilon, inf=inf)
        g_o, g_d, g_p0, g_r, g_share = bounce_vjp(cast_forward(fw, acc), go[idx], gd[idx])
        onehot = (hid[:, None] == sphere_ids[None, :]).to(acc)
        gp += onehot.T @ torch.cat([g_p0, _col(g_r)], dim=1)
        n_tied = int((fw.ties > 1).sum())
        if n_tied:
            tied_bounces += n_tied
            t_o, t_d, t_sphere = tie_vjp(spheres, o_k, d_k, fw, g_share, epsilon=epsilon,
                                         inf=inf)
            g_o, g_d = g_o + t_o, g_d + t_d
            gp += t_sphere
        go[idx], gd[idx] = g_o, g_d
    s, t, u4 = screen
    swept = torch.nonzero(miss_at >= 0).squeeze(1)
    g_cam = camera_vjp(camera, s[swept].to(acc), t[swept].to(acc), u4[swept, 2].to(acc),
                       u4[swept, 3].to(acc), directions[swept].to(acc), go[swept], gd[swept])
    partials = torch.cat([gp[:, :3].reshape(-1), gp[:, 3], g_cam.sum(dim=0)])
    missed = int(swept.numel())
    sweep_bounces = int(miss_at[swept].sum()) if missed else 0
    return partials, {"segments": segments, "depth": depth, "missed": missed,
                      "sweep_bounces": sweep_bounces, "tied_bounces": tied_bounces}


def geometry_grads_from_partials(scene, partials, camera: bool = True):
    """``{'p0', 'radius', 'camera'}`` from a ``[4N+14]`` partials vector
    (module docstring layout), in the scene's dtype.  The camera partials
    are taken to the eight ``CameraConfig`` leaves by autograd through
    ``build_camera`` (in the partials' dtype); with ``camera`` False they
    are not, and the dict holds p0 and radius alone."""
    from ..models.camera import FIELDS, CameraConfig, build_camera

    n = scene.num_spheres
    b = {k: partials[sl] for k, sl in geometry_partial_blocks(n).items()}
    dt = scene.dtype
    out = {"p0": b["p0"].reshape(n, 3).to(dt), "radius": b["radius"].to(dt)}
    if not camera:
        return out
    with torch.enable_grad():
        leaves = {f: getattr(scene.camera, f).detach().to(partials.dtype).requires_grad_(True)
                  for f in FIELDS}
        cam = build_camera(CameraConfig(**leaves))
        packed = torch.cat([cam.position, cam.lower_left, cam.cam_x, cam.cam_y,
                            cam.lens_radius.reshape(1), cam.origin_advance.reshape(1)])
        g = torch.autograd.grad((packed * b["camera"]).sum(), [leaves[f] for f in FIELDS],
                                allow_unused=True, materialize_grads=True)
    return {**out, "camera": CameraConfig(**{f: v.to(dt) for f, v in zip(FIELDS, g)})}

