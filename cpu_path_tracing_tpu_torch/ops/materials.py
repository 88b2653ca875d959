"""Material scattering, batched and branch-free.

Counterpart of ``cpu_path_tracing_tpu/ops/materials.py``: the reference's
``diffuse_ray`` / ``specular_ray`` / ``dielectric_ray``
(``src/main.cpp:44-97``) computed for every ray and blended by the one-hot
material mask (``src/main.cpp:141-154``).  The expression chains are the
CUDA kernel's (``csrc/step_math.cuh``); every sampler is total (no NaN for
any ray), so the blend with 0/1 masks is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .intersect import rsqrt_safe

# src/main.cpp:71 — index 2.0, not the sandbox's 1.5 (sandbox/main.cpp:204).
REFRACTION_INDEX = 2.0


def _sqrt_safe(x):
    # torch.maximum and torch.minimum split a tie's gradient evenly, as
    # jnp.maximum and jnp.minimum do (torch.clamp passes all of it).
    return torch.sqrt(torch.maximum(x, x.new_zeros(())))


def sample_diffuse_c(nx, ny, nz, u_phi, u_sin2):
    """Cosine-weighted hemisphere about the front-facing normal
    (``src/main.cpp:44-58``): phi = 2*pi*u, sin(theta) = sqrt(u'), ONB with
    the |n.x| > 0.1 axis pick."""
    phi = (2.0 * torch.pi) * u_phi
    sin_t = torch.sqrt(u_sin2)
    cos_t = _sqrt_safe(1.0 - u_sin2)
    # axis = (0,1,0) when |n.x| > 0.1 else (1,0,0); u = cross(axis, n)
    ax_y = torch.abs(nx) > 0.1
    zero = torch.zeros_like(nz)
    ux_r = torch.where(ax_y, nz, zero)
    uy_r = torch.where(ax_y, zero, -nz)
    uz_r = torch.where(ax_y, -nx, ny)
    uinv = rsqrt_safe(ux_r * ux_r + uy_r * uy_r + uz_r * uz_r)
    ux, uy, uz = ux_r * uinv, uy_r * uinv, uz_r * uinv
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    cp, sp = torch.cos(phi), torch.sin(phi)
    ddx = ux * cp * sin_t + vx * sp * sin_t + nx * cos_t
    ddy = uy * cp * sin_t + vy * sp * sin_t + ny * cos_t
    ddz = uz * cp * sin_t + vz * sp * sin_t + nz * cos_t
    dinv = rsqrt_safe(ddx * ddx + ddy * ddy + ddz * ddz)
    return ddx * dinv, ddy * dinv, ddz * dinv


def sample_specular_c(dx, dy, dz, nox, noy, noz):
    """Mirror reflection about the outward normal (``src/main.cpp:60-67``;
    the reference's zero "fuzz" is a no-op and is dropped)."""
    ndotd = nox * dx + noy * dy + noz * dz
    return dx - 2.0 * nox * ndotd, dy - 2.0 * noy * ndotd, dz - 2.0 * noz * ndotd


def sample_dielectric_c(dx, dy, dz, a_quad, nx, ny, nz, front, u_choice, *,
                        ior=REFRACTION_INDEX, spx, spy, spz):
    """RTIOW dielectric (``src/main.cpp:69-97``): Schlick-probability
    reflect-vs-refract choice.  The index ratio is rounded to float32 in
    every dtype, as the kernel and the JAX package hold it.  Returns
    (ddx, ddy, ddz, reflected), the direction unnormalized."""
    ratio = torch.where(front, float(np.float32(1.0 / ior)),
                        float(np.float32(ior))).to(dx.dtype)
    dinv = rsqrt_safe(a_quad)
    udx, udy, udz = dx * dinv, dy * dinv, dz * dinv
    cos_d = torch.minimum(-(udx * nx + udy * ny + udz * nz), dx.new_ones(()))
    sin_d = _sqrt_safe(1.0 - cos_d * cos_d)
    cannot = ratio * sin_d > 1.0
    # Schlick reflectance (src/main.cpp:82-87)
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    mm = torch.maximum(1.0 - cos_d, dx.new_zeros(()))
    reflprob = r0 + (1.0 - r0) * (mm * mm * mm * mm * mm)
    reflected = cannot | (reflprob > u_choice)
    ppx = (udx + nx * cos_d) * ratio
    ppy = (udy + ny * cos_d) * ratio
    ppz = (udz + nz * cos_d) * ratio
    kk = torch.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz))  # abs: main.cpp:94
    # sqrt(kk) with a guard at kk == 0, where sqrt's derivative is infinite:
    # a ray whose refraction leaves exactly tangent (float32 finds such rays)
    # would otherwise turn a zero cotangent into NaN (0 * inf) and poison
    # every parameter's gradient.  The value is sqrt(kk)'s, bit for bit.
    zero_k = kk == 0.0
    neg_sqrt_k = -torch.where(zero_k, torch.zeros_like(kk),
                              torch.sqrt(torch.where(zero_k, 1.0, kk)))
    ddx = torch.where(reflected, spx, ppx + nx * neg_sqrt_k)
    ddy = torch.where(reflected, spy, ppy + ny * neg_sqrt_k)
    ddz = torch.where(reflected, spz, ppz + nz * neg_sqrt_k)
    return ddx, ddy, ddz, reflected


def scatter(mat_mask, d_in, outward_normal, normal, front, u_a, u_b, ior=REFRACTION_INDEX):
    """Blend the three samplers by the one-hot material mask [B,3]
    (diffuse, specular, dielectric).  Diffuse draws (u_a, u_b), the
    dielectric lottery u_a.  Returns new directions [B,3]."""
    dx, dy, dz = d_in[:, 0], d_in[:, 1], d_in[:, 2]
    nox, noy, noz = outward_normal[:, 0], outward_normal[:, 1], outward_normal[:, 2]
    nx, ny, nz = normal[:, 0], normal[:, 1], normal[:, 2]
    a_quad = dx * dx + dy * dy + dz * dz

    ddx, ddy, ddz = sample_diffuse_c(nx, ny, nz, u_a, u_b)
    spx, spy, spz = sample_specular_c(dx, dy, dz, nox, noy, noz)
    dlx, dly, dlz, _ = sample_dielectric_c(dx, dy, dz, a_quad, nx, ny, nz, front, u_a,
                                           ior=ior, spx=spx, spy=spy, spz=spz)
    m_dif, m_spe, m_die = mat_mask[:, 0], mat_mask[:, 1], mat_mask[:, 2]
    return torch.stack([m_dif * ddx + m_spe * spx + m_die * dlx,
                        m_dif * ddy + m_spe * spy + m_die * dly,
                        m_dif * ddz + m_spe * spz + m_die * dlz], dim=-1)
