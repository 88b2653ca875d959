"""Batched ray-sphere intersection.

Counterpart of ``cpu_path_tracing_tpu/ops/intersect.py``: one broadcast
[B, N] quadratic solve in the anchor-point form (``models/scene.py``) with
the stable q-root, nearest root >= epsilon, lowest sphere index on ties
(the reference's strict ``d < t`` scan, ``src/main.cpp:34-39``).

Every dot product is the explicit left-associated chain
``x0*y0 + x1*y1 + x2*y2`` and every division by a computed value a
reciprocal-multiply where the kernel has one: the same expressions as the
CUDA kernel (``csrc/step_math.cuh``), so the two round alike.

``scene`` here is anything with the sphere fields ``p0``, ``radius``,
``anchor_dir``, ``emission``, ``albedo``, ``material``: a ``Scene`` or the
unpacked kernel table (``ops/kernels/megakernel.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def rsqrt_safe(x: torch.Tensor) -> torch.Tensor:
    """``1/sqrt(x)`` with a guard at x <= 0.  Written as a correctly rounded
    divide of a correctly rounded sqrt, as the CUDA kernel computes it
    (CUDA's ``rsqrtf`` is not correctly rounded)."""
    return 1.0 / torch.sqrt(torch.where(x > 0, x, torch.ones_like(x)))


def sphere_roots(scene, origins, directions, epsilon=1e-4, inf=1e20):
    """Each sphere's root for each ray, [B,N]: the nearest root >= epsilon,
    ``inf`` where there is none.  ``origins``, ``directions``: [B,3]
    (directions need not be normalized)."""
    r = scene.radius[None, :]
    p0, ad = scene.p0, scene.anchor_dir
    ox, oy, oz = origins[:, 0:1], origins[:, 1:2], origins[:, 2:3]
    dx, dy, dz = directions[:, 0:1], directions[:, 1:2], directions[:, 2:3]

    qx, qy, qz = ox - p0[None, :, 0], oy - p0[None, :, 1], oz - p0[None, :, 2]
    adx, ady, adz = ad[None, :, 0], ad[None, :, 1], ad[None, :, 2]
    a = dx * dx + dy * dy + dz * dz
    qd = qx * dx + qy * dy + qz * dz
    add = adx * dx + ady * dy + adz * dz
    b = qd + r * add  # oc.d
    qq = qx * qx + qy * qy + qz * qz
    qad = qx * adx + qy * ady + qz * adz
    c = qq + 2.0 * r * qad  # oc.oc - r^2, cancellation-free

    disc = b * b - a * c
    has_root = disc >= 0.0
    # A tangent ray (disc == 0) takes sqrt's value 0 without its infinite
    # derivative, which would turn a zero cotangent into NaN (0 * inf).
    tangent = disc == 0.0
    sqrtd = torch.where(tangent, torch.zeros_like(disc),
                        torch.sqrt(torch.where(has_root & ~tangent, disc, torch.ones_like(disc))))
    sign_b = torch.where(b >= 0.0, 1.0, -1.0).to(b.dtype)
    qform = -(b + sign_b * sqrtd)
    nonzero = qform != 0.0
    a_inv = 1.0 / a  # hoisted: one divide per ray, not per (ray, sphere)
    root_1 = qform * a_inv
    root_2 = torch.where(nonzero, c / torch.where(nonzero, qform, torch.ones_like(qform)),
                         torch.full_like(qform, inf))
    t_near = torch.minimum(root_1, root_2)
    t_far = torch.maximum(root_1, root_2)
    inf_t = torch.full_like(t_near, inf)
    # src/sphere.cpp:19-28: near root if >= epsilon, else far root, else miss.
    root = torch.where(t_near >= epsilon, t_near, torch.where(t_far >= epsilon, t_far, inf_t))
    return torch.where(has_root, root, inf_t)


def intersect_scene(scene, origins, directions, epsilon=1e-4, inf=1e20):
    """Intersect a ray batch against every sphere (``sphere_roots``).

    Returns ``t`` [B] (``inf`` on a miss), ``hit_id`` [B] int64 (first index
    on ties) and ``hit`` [B] bool."""
    root = sphere_roots(scene, origins, directions, epsilon=epsilon, inf=inf)
    # amin splits a tie's gradient evenly, as jnp.min does (torch.min(dim)
    # would send all of it to the returned index); argmin is the first index.
    t = root.amin(dim=-1)
    hit_id = root.argmin(dim=-1)
    return t, hit_id, t < inf


class SphereProps(NamedTuple):
    """Per-ray properties of the hit sphere (all [B,...])."""

    center: torch.Tensor  # [B,3] p0 - radius*anchor_dir
    emission: torch.Tensor  # [B,3]
    albedo: torch.Tensor  # [B,3]
    mat_mask: torch.Tensor  # [B,3] one-hot (diffuse, specular, dielectric)


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` with a backward that repeats bitwise on the card.

    The backward of an index is an atomic scatter-add on CUDA, whose float
    sums depend on the order the atomics land in.  Here a row's gradient is
    the JAX package's one-hot product (``onehot.T @ g``) written as a
    broadcast multiply and a sum over the batch: no atomics, and no matmul
    that TF32 could round."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = (idx[:, None] == torch.arange(ctx.rows, device=idx.device)).to(g.dtype)
        return (onehot[:, :, None] * g[:, None, :]).sum(dim=0), None


def sphere_props(scene, hit_id) -> SphereProps:
    """The hit sphere's data for each ray: an exact index gather forward
    (the values of the JAX package's one-hot matmul at HIGHEST precision),
    and a deterministic backward (``_GatherRows``)."""
    center = scene.p0 - scene.radius[:, None] * scene.anchor_dir
    rows = _GatherRows.apply(torch.cat([center, scene.emission, scene.albedo], dim=1), hit_id)
    mats = torch.nn.functional.one_hot(scene.material.long(), 3).to(scene.p0.dtype)
    return SphereProps(center=rows[:, 0:3], emission=rows[:, 3:6], albedo=rows[:, 6:9],
                       mat_mask=mats[hit_id])


def hit_record(origins, directions, t, props: SphereProps):
    """Batched ``pt::get_hit_record_at`` (``src/hit_record.cpp:3-12``).

    ``t`` must be finite on miss rays.  Returns (hit_point [B,3],
    outward_normal [B,3], front-facing normal [B,3], front [B])."""
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = directions[:, 0], directions[:, 1], directions[:, 2]
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    # Outward normal = normalized (hit - center); the 1/r scale is absorbed.
    nrx = hx - props.center[:, 0]
    nry = hy - props.center[:, 1]
    nrz = hz - props.center[:, 2]
    ninv = rsqrt_safe(nrx * nrx + nry * nry + nrz * nrz)
    nox, noy, noz = nrx * ninv, nry * ninv, nrz * ninv
    ndotd = nox * dx + noy * dy + noz * dz
    front = ndotd < 0.0
    fsign = torch.where(front, 1.0, -1.0).to(ox.dtype)
    n_out = torch.stack([nox, noy, noz], dim=-1)
    return torch.stack([hx, hy, hz], dim=-1), n_out, n_out * fsign[:, None], front
