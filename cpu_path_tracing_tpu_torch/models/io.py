"""Scenes as JSON-style dicts.

Counterpart of the loading half of ``cpu_path_tracing_tpu/models/io.py``
(the registered ``clear_light`` and ``greenish_party`` scenes are stored in
this form).  ``aspect_ratio`` comes from the render resolution at load time.
When every sphere carries the ``anchor_dir`` that the JAX package's
``scene_to_dict`` saves, those anchors are used, so a saved scene loads to
the same ``p0``; otherwise anchors are derived from the camera's look-at
point.
"""

from __future__ import annotations

import torch

from .camera import CameraConfig
from .scene import DIELECTRIC, DIFFUSE, SPECULAR, SKY_GRADIENT, Scene, scene_from_spheres

MATERIAL_IDS = {"diffuse": DIFFUSE, "specular": SPECULAR, "dielectric": DIELECTRIC}


def scene_from_dict(d: dict, width: int, height: int, dtype=torch.float32) -> Scene:
    """JSON dict -> Scene (aspect ratio from the render resolution)."""
    spheres = [
        (s["radius"], s["center"], s.get("emission", (0.0, 0.0, 0.0)), s["albedo"],
         MATERIAL_IDS[s.get("material", "diffuse")])
        for s in d["spheres"]
    ]
    c = d["camera"]
    camera = CameraConfig.make(
        position=c["position"],
        look_at=c["look_at"],
        up=tuple(c.get("up", (0.0, 1.0, 0.0))),
        aspect_ratio=width / height,
        vertical_fov_radians=c["vfov"],
        aperture=c.get("aperture", 0.0),
        focus_distance=c.get("focus_distance"),
        origin_advance=c.get("origin_advance", 0.0),
        dtype=dtype,
    )
    anchor_dirs = None
    if d["spheres"] and all("anchor_dir" in s for s in d["spheres"]):
        anchor_dirs = [s["anchor_dir"] for s in d["spheres"]]
    return scene_from_spheres(spheres, camera, dtype=dtype,
                              background=d.get("background", SKY_GRADIENT),
                              anchor_dirs=anchor_dirs, ior=float(d.get("ior", 2.0)))

