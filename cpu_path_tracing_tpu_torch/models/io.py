"""Scenes as JSON documents.

Counterpart of ``cpu_path_tracing_tpu/models/io.py``, in its format:

    {"camera": {"position": [...], "look_at": [...], "up": [0,1,0],
                "vfov": 0.75, "aperture": 0.2, "focus_distance": 1.4,
                "origin_advance": 0.0},
     "background": [[1,1,1],[0.5,0.7,1.0]], "ior": 2.0,
     "spheres": [{"radius": 0.2, "center": [0,0.1,-1.4], "emission": [9,9,9],
                  "albedo": [1.8,1.8,1.8], "material": "diffuse",
                  "anchor_dir": [...]}, ...]}

(the registered ``clear_light`` and ``greenish_party`` scenes are stored in
this form).  ``scene_to_dict`` writes the scene's fields as float64 values,
so a file written by either package loads in the other to the same arrays.
``aspect_ratio`` comes from the render resolution at load time.  When every
sphere carries its ``anchor_dir``, those anchors are used, so a saved scene
loads to the same ``p0``; otherwise anchors are derived from the camera's
look-at point.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .camera import CameraConfig
from .scene import DIELECTRIC, DIFFUSE, SPECULAR, SKY_GRADIENT, Scene, scene_from_spheres

MATERIAL_IDS = {"diffuse": DIFFUSE, "specular": SPECULAR, "dielectric": DIELECTRIC}
MATERIAL_NAMES = {v: k for k, v in MATERIAL_IDS.items()}


def scene_to_dict(scene: Scene) -> dict:
    """Scene -> JSON-able dict (float64 values of the fields, on the host)."""
    def g(x):
        return x.detach().cpu().numpy().astype(np.float64)

    radius, anchor_dir = g(scene.radius), g(scene.anchor_dir)
    centers = g(scene.p0) - radius[:, None] * anchor_dir
    emission, albedo = g(scene.emission), g(scene.albedo)
    material = scene.material.cpu().numpy()
    cam = scene.camera
    spheres = [
        {
            "radius": float(radius[i]),
            "center": centers[i].tolist(),
            "emission": emission[i].tolist(),
            "albedo": albedo[i].tolist(),
            "material": MATERIAL_NAMES[int(material[i])],
            # The anchor of the parametrization, so that a load gives p0 back.
            "anchor_dir": anchor_dir[i].tolist(),
        }
        for i in range(scene.num_spheres)
    ]
    return {
        "camera": {
            "position": g(cam.position).tolist(),
            "look_at": g(cam.look_at).tolist(),
            "up": g(cam.up).tolist(),
            "vfov": float(g(cam.vertical_fov_radians)),
            "aperture": float(g(cam.aperture)),
            "focus_distance": float(g(cam.focus_distance)),
            "origin_advance": float(g(cam.origin_advance)),
        },
        "background": g(scene.background).tolist(),
        "ior": float(scene.ior),
        "spheres": spheres,
    }


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



def save_scene(path: str, scene: Scene) -> None:
    with open(path, "w") as fh:
        json.dump(scene_to_dict(scene), fh, indent=1)


def load_scene(path: str, width: int, height: int, dtype=torch.float32) -> Scene:
    """A scene file, on the CPU; ``.to(device)`` moves it."""
    with open(path) as fh:
        return scene_from_dict(json.load(fh), width, height, dtype=dtype)
