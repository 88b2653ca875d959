"""Thin-lens camera.

Counterpart of ``cpu_path_tracing_tpu/models/camera.py``; reproduces the
reference camera (``src/camera.cpp:3-38``) with its two quirks: the defocus
offset is ``rd*s + rd*t`` (the lens-disk point scaled by the screen
coordinates), and primary directions are not normalized.  The rejection
loop for the disk sample is the closed-form polar map
``(sqrt(u1), 2*pi*u2)``.

``CameraConfig`` is an ``nn.Module`` whose fields are buffers, so
``Scene.to(device)`` moves it with the spheres.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

FIELDS = ("position", "look_at", "up", "aspect_ratio", "vertical_fov_radians",
          "aperture", "focus_distance", "origin_advance")


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


class CameraConfig(nn.Module):
    """Mirror of ``pt::camera_config`` (``src/camera.hpp:11-21``); ``look_at``
    is the reference's misnamed ``direction`` point."""

    def __init__(self, **fields: torch.Tensor):
        super().__init__()
        if set(fields) != set(FIELDS):
            raise ValueError(f"CameraConfig needs exactly the fields {FIELDS}")
        for name in FIELDS:
            self.register_buffer(name, fields[name])

    @staticmethod
    def make(position, look_at, aspect_ratio, vertical_fov_radians, aperture,
             focus_distance=None, up=(0.0, 1.0, 0.0), origin_advance=0.0,
             dtype=torch.float32, device=None) -> "CameraConfig":
        def f(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        position, look_at = f(position), f(look_at)
        if focus_distance is None:
            # All reference scenes focus on the look-at point, in the
            # working dtype (src/box_mirror_scene.hpp:69).
            focus_distance = _norm3(position - look_at)
        return CameraConfig(
            position=position, look_at=look_at, up=f(up),
            aspect_ratio=f(aspect_ratio),
            vertical_fov_radians=f(vertical_fov_radians),
            aperture=f(aperture), focus_distance=f(focus_distance),
            origin_advance=f(origin_advance))


class Camera(NamedTuple):
    """Derived camera frame — mirror of ``pt::camera`` (``src/camera.hpp:23-32``)."""

    position: torch.Tensor  # [3]
    lower_left: torch.Tensor  # [3]
    cam_x: torch.Tensor  # [3]
    cam_y: torch.Tensor  # [3]
    lens_radius: torch.Tensor  # scalar
    origin_advance: torch.Tensor  # scalar


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _normalize(v: torch.Tensor) -> torch.Tensor:
    sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    return v * torch.rsqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))


def build_camera(cfg: CameraConfig) -> Camera:
    """``pt::camera::with_config`` (``src/camera.cpp:3-17``)."""
    viewport_h = 2.0 * torch.tan(0.5 * cfg.vertical_fov_radians)
    viewport_w = cfg.aspect_ratio * viewport_h
    w = _normalize(cfg.position - cfg.look_at)
    u = _normalize(_cross(cfg.up, w))
    v = _cross(w, u)
    cam_x = u * (viewport_w * cfg.focus_distance)
    cam_y = v * (viewport_h * cfg.focus_distance)
    lower_left = cfg.position - 0.5 * cam_x - 0.5 * cam_y - w * cfg.focus_distance
    return Camera(position=cfg.position, lower_left=lower_left, cam_x=cam_x,
                  cam_y=cam_y, lens_radius=0.5 * cfg.aperture,
                  origin_advance=cfg.origin_advance)


def get_rays(cam: Camera, s, t, u_disk1, u_disk2):
    """Batched ``pt::camera::get_ray`` (``src/camera.cpp:32-38``).

    ``s, t``: [B] screen coordinates; ``u_disk1, u_disk2``: [B] lens-disk
    uniforms.  Returns (origins [B,3], directions [B,3]), directions not
    normalized.  Product order is the kernel's: ``(sqrt(u)*lens_r)*cos``."""
    r = torch.sqrt(u_disk1) * cam.lens_radius
    theta = (2.0 * torch.pi) * u_disk2
    rd = torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)
    offset = rd * (s + t)[:, None]  # the rd*(s+t) quirk (src/camera.cpp:35)
    origin = cam.position[None, :] + offset
    direction = (cam.lower_left[None, :] + cam.cam_x[None, :] * s[:, None]
                 + cam.cam_y[None, :] * t[:, None] - cam.position[None, :] - offset)
    # Near-clip advance along the unnormalized direction (smallpt's
    # ``cam.o + d*140``; 0 for the src/ camera).
    origin = origin + cam.origin_advance * direction
    return origin, direction
