"""Scene: structure-of-arrays sphere list + camera, as an ``nn.Module``.

Counterpart of ``cpu_path_tracing_tpu/models/scene.py``.  Spheres use the
anchor-point parametrization of that module (``p0 = center + radius *
anchor_dir``, computed once in float64 NumPy and then cast), which keeps the
intersection quadratic free of cancellation in float32 even for the r=1e6
wall spheres.

The arrays are buffers, so ``scene.to(device)`` moves the whole scene and
the renderer works where the scene lives.  ``ior`` (dielectric refraction
index) is a plain Python float, as the JAX meta field is.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from .camera import FIELDS as CAMERA_FIELDS
from .camera import CameraConfig

# Material ids — mirror of ``pt::reflection_type`` (src/reflection.hpp:7-12).
DIFFUSE = 0
SPECULAR = 1
DIELECTRIC = 2

SPHERE_FIELDS = ("p0", "radius", "anchor_dir", "emission", "albedo", "material")

# The reference's sky gradient endpoints (src/main.cpp:116-119).
SKY_GRADIENT = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
BLACK_BACKGROUND = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0))


class Scene(nn.Module):
    """SoA sphere list (+ camera): p0 [N,3], radius [N], anchor_dir [N,3],
    emission [N,3], albedo [N,3], material [N] int32, background [2,3]
    (miss radiance bottom/top), camera, and ``ior``."""

    def __init__(self, p0, radius, anchor_dir, emission, albedo, material,
                 camera: CameraConfig, background, ior: float = 2.0):
        super().__init__()
        self.register_buffer("p0", p0)
        self.register_buffer("radius", radius)
        self.register_buffer("anchor_dir", anchor_dir)
        self.register_buffer("emission", emission)
        self.register_buffer("albedo", albedo)
        self.register_buffer("material", material)
        self.register_buffer("background", background)
        self.camera = camera
        self.ior = float(ior)

    @property
    def num_spheres(self) -> int:
        return self.p0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.p0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.p0.dtype


def scene_from_spheres(spheres, camera: CameraConfig, anchor_toward=None,
                       dtype=torch.float32, background=SKY_GRADIENT,
                       anchor_dirs=None, ior: float = 2.0) -> Scene:
    """Build a Scene from (radius, center[3], emission[3], albedo[3], mat_id)
    tuples.  All anchor math is float64 NumPy before the cast to ``dtype``
    (``cpu_path_tracing_tpu/models/scene.py:144-178``).  ``anchor_dirs``
    ([N,3] unit vectors) overrides the anchors derived from
    ``anchor_toward``; ``models/io.py`` passes the saved ones so that a
    saved scene loads to the same ``p0``."""
    if anchor_toward is None:
        anchor_toward = camera.look_at.detach().cpu().numpy().astype(np.float64)
    else:
        anchor_toward = np.asarray(anchor_toward, np.float64)

    radii, centers, emissions, albedos, materials = [], [], [], [], []
    for r, c, e, a, m in spheres:
        radii.append(float(r))
        centers.append(np.asarray(c, np.float64))
        emissions.append(np.asarray(e, np.float64))
        albedos.append(np.asarray(a, np.float64))
        materials.append(int(m))

    radii = np.asarray(radii, np.float64)
    centers = np.stack(centers)
    if anchor_dirs is not None:
        anchor_dir = np.asarray(anchor_dirs, np.float64)
    else:
        toward = anchor_toward[None, :] - centers
        norms = np.linalg.norm(toward, axis=-1, keepdims=True)
        # Degenerate case (center == point of interest): a fixed axis.
        anchor_dir = np.where(norms > 0, toward / np.where(norms > 0, norms, 1.0),
                              np.array([0.0, 0.0, 1.0]))
    p0 = centers + radii[:, None] * anchor_dir

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype)

    return Scene(p0=f(p0), radius=f(radii), anchor_dir=f(anchor_dir),
                 emission=f(np.stack(emissions)), albedo=f(np.stack(albedos)),
                 material=torch.as_tensor(materials, dtype=torch.int32),
                 camera=camera, background=f(background), ior=ior)


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def scene_from_arrays(arrays: Dict[str, np.ndarray], ior: float) -> Scene:
    """Build a Scene from the JAX ``Scene``'s fields given as NumPy arrays:
    the six sphere fields, ``background`` and the eight ``CameraConfig``
    fields, either at the top level or as a dict under ``camera`` (the
    params-dict form, ``params_from_arrays``).  The arrays are copied
    exactly, in their own dtype; nothing is recomputed."""
    flat = dict(arrays)
    flat.update(flat.pop("camera", {}))
    missing = set(SPHERE_FIELDS + CAMERA_FIELDS + ("background",)) - set(flat)
    if missing:
        raise KeyError(f"scene_from_arrays: missing fields {sorted(missing)}")
    camera = CameraConfig(**{n: _tensor(flat[n]) for n in CAMERA_FIELDS})
    return Scene(**{n: _tensor(flat[n]) for n in SPHERE_FIELDS}, camera=camera,
                 background=_tensor(flat["background"]), ior=ior)


def params_from_arrays(arrays: Dict[str, object]) -> Dict[str, object]:
    """The port's params dict (``grad.split_params``'s form) from the JAX
    package's params as NumPy: each field an array, ``camera`` a dict of the
    eight ``CameraConfig`` fields (which becomes a ``CameraConfig``).
    Copied exactly, in their own dtype."""
    out = {k: _tensor(v) for k, v in arrays.items() if k != "camera"}
    if "camera" in arrays:
        out["camera"] = CameraConfig(**{n: _tensor(arrays["camera"][n]) for n in CAMERA_FIELDS})
    return out


# Scene registry — replaces the reference's compile-time #include swap
# (src/main.cpp:23-25).
_REGISTRY: Dict[str, Callable[..., Scene]] = {}


def register_scene(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_scene(name: str, width: int, height: int, dtype=torch.float32) -> Scene:
    """A registered scene, on the CPU; ``.to(device)`` moves it."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scene {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](width, height, dtype=dtype)


def scene_names():
    return sorted(_REGISTRY)
