"""Scenes and the thin-lens camera, built from a configuration file's data.

A sphere is ``[radius, center xyz, emission rgb, albedo rgb, material]``
(material 0 diffuse, 1 specular, 2 dielectric), as the upstream scene
headers list them.  Spheres are held in the anchor-point form ``p0 =
center + radius * anchor_dir`` with ``anchor_dir`` the unit vector toward
the camera's look-at point, worked out in float64 and then cast, which
keeps the intersection quadratic free of cancellation in float32 for the
r = 1e6 wall spheres.  The camera is the upstream ``pt::camera``
(``src/camera.cpp:3-38``) with its two quirks: the defocus offset is the
lens-disk point scaled by ``s + t``, and primary directions are not
normalized.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch


def _norm3(v):
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def camera_fields(cam: dict, width: int, height: int, dtype) -> dict:
    """The camera's settings as tensors on the host, in ``dtype``; the focus
    distance, when the file leaves it out, is the look-at distance in that
    dtype."""
    def f(x):
        return torch.as_tensor(x, dtype=dtype)

    position, look_at = f(cam["position"]), f(cam["look_at"])
    focus = cam.get("focus_distance")
    return {"position": position, "look_at": look_at, "up": f(cam.get("up", (0.0, 1.0, 0.0))),
            "aspect_ratio": f(width / height), "vertical_fov_radians": f(cam["vertical_fov"]),
            "aperture": f(cam["aperture"]),
            "focus_distance": _norm3(position - look_at) if focus is None else f(focus),
            "origin_advance": f(cam.get("origin_advance", 0.0))}


def build_scene(config: dict, device, dtype=torch.float32) -> SimpleNamespace:
    """The configuration's scene on ``device`` in ``dtype``: sphere tensors,
    ``material`` (int64), ``background`` [2,3], ``ior`` and ``camera`` (the
    settings of ``camera_fields``)."""
    spheres = config["scene"]["spheres"]
    cam = camera_fields(config["scene"]["camera"], config["width"], config["height"], dtype)
    toward = cam["look_at"].to(torch.float64).numpy()
    radii = np.array([s[0] for s in spheres], np.float64)
    centers = np.array([s[1:4] for s in spheres], np.float64)
    to = toward[None, :] - centers
    norms = np.linalg.norm(to, axis=-1, keepdims=True)
    anchor = np.where(norms > 0, to / np.where(norms > 0, norms, 1.0), np.array([0.0, 0.0, 1.0]))

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype).to(device)

    return SimpleNamespace(
        p0=f(centers + radii[:, None] * anchor), radius=f(radii), anchor_dir=f(anchor),
        emission=f([s[4:7] for s in spheres]), albedo=f([s[7:10] for s in spheres]),
        material=torch.as_tensor([int(s[10]) for s in spheres], device=device),
        background=f(config["scene"]["background"]), ior=float(config["scene"]["ior"]),
        camera={k: v.to(device) for k, v in cam.items()})


def with_params(scene, params: dict) -> SimpleNamespace:
    """A copy of ``scene`` with the sphere fields of ``params`` in place."""
    out = SimpleNamespace(**vars(scene))
    for k, v in params.items():
        setattr(out, k, v)
    return out


def _normalize(v):
    sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    return v * torch.rsqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def camera_frame(cam: dict) -> SimpleNamespace:
    """``pt::camera::with_config`` (``src/camera.cpp:3-17``)."""
    viewport_h = 2.0 * torch.tan(0.5 * cam["vertical_fov_radians"])
    viewport_w = cam["aspect_ratio"] * viewport_h
    w = _normalize(cam["position"] - cam["look_at"])
    u = _normalize(_cross(cam["up"], w))
    v = _cross(w, u)
    cam_x = u * (viewport_w * cam["focus_distance"])
    cam_y = v * (viewport_h * cam["focus_distance"])
    lower_left = cam["position"] - 0.5 * cam_x - 0.5 * cam_y - w * cam["focus_distance"]
    return SimpleNamespace(position=cam["position"], lower_left=lower_left, cam_x=cam_x,
                           cam_y=cam_y, lens_radius=0.5 * cam["aperture"],
                           origin_advance=cam["origin_advance"])


def primary_rays(frame, s, t, u_disk1, u_disk2):
    """``pt::camera::get_ray`` (``src/camera.cpp:32-38``) for [B] screen
    coordinates and lens-disk uniforms: (origins [B,3], directions [B,3])."""
    r = torch.sqrt(u_disk1) * frame.lens_radius
    theta = (2.0 * math.pi) * u_disk2
    rd = torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)
    offset = rd * (s + t)[:, None]
    origin = frame.position[None, :] + offset
    direction = (frame.lower_left[None, :] + frame.cam_x[None, :] * s[:, None]
                 + frame.cam_y[None, :] * t[:, None] - frame.position[None, :] - offset)
    return origin + frame.origin_advance * direction, direction
