"""Built-in scenes: the 13 registered scenes of the JAX package.

Counterpart of ``cpu_path_tracing_tpu/models/scenes.py``, with the same
scene data transcribed from the reference's headers (``src/*_scene.hpp``)
and the vendored sandbox smallpt (``sandbox/main.cpp:94-123``), stored in
float64 and converted to the anchor-point parametrization by
``scene_from_spheres``.  ``random_spheres`` draws from NumPy's
``default_rng(7)``, so every scene equals the JAX package's exactly.
"""

from __future__ import annotations

import math

import torch
import numpy as np

from .camera import CameraConfig
from .scene import (
    BLACK_BACKGROUND,
    DIFFUSE,
    SPECULAR,
    DIELECTRIC,
    Scene,
    register_scene,
    scene_from_spheres,
)


@register_scene("simple")
def simple_scene(width: int, height: int, dtype=torch.float32) -> Scene:
    """5 spheres + sky; ``src/simple_scene.hpp:14-52``."""
    spheres = [
        # (radius, center, emission, albedo, material)
        (100.0, (0.0, -100.5, -1.0), (0.0, 0.0, 0.0), (0.8, 0.8, 0.0), DIFFUSE),  # ground
        (0.5, (1.0, 0.0, -1.0), (0.0, 0.0, 0.0), (0.999, 0.999, 0.999), SPECULAR),  # right
        (0.5, (-1.0, 0.0, -1.0), (0.0, 0.0, 0.0), (0.999, 0.999, 0.999), DIELECTRIC),  # left
        (0.5, (0.0, 0.0, -1.0), (0.1, 0.1, 0.9), (0.0, 0.7, 0.1), DIFFUSE),  # light center
        (1.0, (1.0, 3.1, -1.0), (30.0, 30.0, 30.0), (0.0, 0.0, 0.0), DIFFUSE),  # light up
    ]
    camera = CameraConfig.make(
        position=(-2.0, 2.0, 1.0),
        look_at=(0.0, 0.0, -1.0),
        aspect_ratio=width / height,
        vertical_fov_radians=1.2,
        aperture=0.2,
        dtype=dtype,
    )
    return scene_from_spheres(spheres, camera, dtype=dtype)


def _box_common(width, height, specular_walls: bool, dtype):
    """Shared geometry of box / box_mirror (``src/box{,_mirror}_scene.hpp``)."""
    big = 1e6
    off = 0.4
    y, z = 0.0, -1.0
    wall_mat = SPECULAR if specular_walls else DIFFUSE
    spheres = [
        (big, (-big - off, y, z), (0.0, 0.0, 0.0), (0.9, 0.1, 0.2), wall_mat),  # left
        (big, (big + off, y, z), (0.0, 0.0, 0.0), (0.3, 0.1, 0.9), wall_mat),  # right
        (big, (0.0, 0.0, z - big), (0.0, 0.0, 0.0), (0.1, 0.7, 0.2), wall_mat),  # back
        (big, (0.0, big + off, z), (0.0, 0.0, 0.0), (0.3, 0.7, 0.2), wall_mat),  # top
        (big, (0.0, -big - off, z), (0.0, 0.0, 0.0), (0.9, 0.9, 0.9), wall_mat),  # bottom
    ]
    camera = CameraConfig.make(
        position=(0.0, 0.0, 2.0),
        look_at=(0.0, 0.0, z + off * 1.5),
        aspect_ratio=width / height,
        vertical_fov_radians=0.5 if not specular_walls else 0.75,
        aperture=0.2,
        dtype=dtype,
    )
    return spheres, camera, off, z


@register_scene("box")
def box_scene(width: int, height: int, dtype=torch.float32) -> Scene:
    """Diffuse-walled Cornell-style box; ``src/box_scene.hpp:14-72``.

    Note the light sphere's albedo 1.8 > 1 (``src/box_scene.hpp:51``): per
    reference semantics Russian roulette then only damps (never kills) paths
    on that sphere (``src/main.cpp:128-137``).
    """
    spheres, camera, off, z = _box_common(width, height, specular_walls=False, dtype=dtype)
    spheres += [
        (off / 2, (0.0, off / 4, z - off / 2.5), (9.0, 9.0, 9.0), (1.8, 1.8, 1.8), DIFFUSE),  # light
        (off / 2, (off / 2, -off / 2, z + off * 1.5), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), SPECULAR),  # mirror
        (off / 2, (-off / 2, -off / 2, z + off * 1.5), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), DIELECTRIC),  # glass
    ]
    return scene_from_spheres(spheres, camera, dtype=dtype)


@register_scene("box_mirror")
def box_mirror_scene(width: int, height: int, dtype=torch.float32) -> Scene:
    """All-mirror box ("disco sphere"); ``src/box_mirror_scene.hpp:14-72``.

    The light has emission == albedo == (1.92, 1.91, 1.9)
    (``src/box_mirror_scene.hpp:50-51``): RR survival prob 1.92 > 1, so paths
    hitting it are never roulette-killed, only damped by 1/1.92.
    """
    spheres, camera, off, z = _box_common(width, height, specular_walls=True, dtype=dtype)
    spheres += [
        (off / 2, (0.0, off / 4, z + off * 1.5), (1.92, 1.91, 1.9), (1.92, 1.91, 1.9), DIFFUSE),  # light
        (off / 2, (off / 2, -off / 2, z + off), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), SPECULAR),  # mirror
        (off / 2, (-off / 2, -off / 2, z + off), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), DIELECTRIC),  # glass
    ]
    return scene_from_spheres(spheres, camera, dtype=dtype)


# Alias matching BASELINE.json's benchmark-config name for box_mirror.
register_scene("disco_sphere")(box_mirror_scene)


@register_scene("smallpt")
def smallpt_scene(width: int, height: int, dtype=torch.float32, ior: float = 2.0) -> Scene:
    """The vendored original smallpt Cornell box (``sandbox/main.cpp:94-123``).

    Camera: the sandbox uses an ad-hoc basis (``sandbox/main.cpp:235-237``,
    dir (0,-0.042612,-1), 0.5135 viewport, origin pushed 140 units forward);
    expressed here as our thin-lens config with aperture 0 and
    vfov = 2*atan(0.5135/2), focusing 140 units along the view direction.
    """
    e5 = 1e5
    spheres = [
        (e5, (e5 + 1, 40.8, 81.6), (0, 0, 0), (0.75, 0.25, 0.25), DIFFUSE),  # left
        (e5, (-e5 + 99, 40.8, 81.6), (0, 0, 0), (0.25, 0.25, 0.75), DIFFUSE),  # right
        (e5, (50.0, 40.8, e5), (0, 0, 0), (0.75, 0.75, 0.75), DIFFUSE),  # back
        (e5, (50.0, 40.8, -e5 + 170), (0, 0, 0), (0.0, 0.0, 0.0), DIFFUSE),  # front
        (e5, (50.0, e5, 81.6), (0, 0, 0), (0.75, 0.75, 0.75), DIFFUSE),  # bottom
        (e5, (50.0, -e5 + 81.6, 81.6), (0, 0, 0), (0.25, 0.75, 0.15), DIFFUSE),  # top
        (16.5, (27.0, 16.5, 47.0), (0, 0, 0), (0.999, 0.999, 0.999), SPECULAR),  # mirror
        (16.5, (65.0, 16.5, 37.0), (0, 0, 0), (0.6, 0.1, 0.6), SPECULAR),  # purple mirror
        (16.5, (45.0, 46.5, 50.0), (22, 22, 22), (0.0, 0.0, 0.0), DIFFUSE),  # light
        (16.5, (73.0, 16.5, 78.0), (0, 0, 0), (0.999, 0.999, 0.999), DIELECTRIC),  # glass
    ]
    # The sandbox projects from the eye (50,52,295.6) but starts every ray
    # 140 units along its own unnormalized direction
    # (``radiance(Ray(cam.o + d*140, ...))``, sandbox/main.cpp:261) — the eye
    # itself sits *outside* the box behind the black front wall at z=170, so
    # the advance is a near-clip.  ``origin_advance=140`` reproduces it
    # exactly; viewport 0.5135 at focus distance 1 matches the sandbox's
    # cx/cy basis (sandbox/main.cpp:235-237).
    eye = (50.0, 52.0, 295.6)
    d = (0.0, -0.042612, -1.0)
    dn = math.sqrt(sum(x * x for x in d))
    dhat = tuple(x / dn for x in d)
    look_at = tuple(e + x for e, x in zip(eye, dhat))
    camera = CameraConfig.make(
        position=eye,
        look_at=look_at,
        aspect_ratio=width / height,
        vertical_fov_radians=2.0 * math.atan(0.5135 / 2.0),
        aperture=0.0,
        origin_advance=140.0,
        dtype=dtype,
    )
    # Black background on miss, matching the sandbox (sandbox/main.cpp:154-156)
    # rather than src/'s sky gradient.  ior stays at the framework default 2.0
    # (the src/main.cpp:71 quirk) — `smallpt_exact` below carries the
    # sandbox's true 1.5.
    return scene_from_spheres(
        spheres, camera, anchor_toward=(50.0, 40.8, 81.6), dtype=dtype,
        background=BLACK_BACKGROUND, ior=ior,
    )


@register_scene("smallpt_exact")
def smallpt_exact_scene(width: int, height: int, dtype=torch.float32) -> Scene:
    """``smallpt`` with the sandbox binary's actual refraction index 1.5
    (``sandbox/main.cpp:204``) instead of the src/ tree's 2.0 quirk — the
    scene half of the REFMATCH.md exact-estimator race (pair it with
    ``RenderConfig(jitter='tent')`` for the sandbox's tent filter)."""
    return smallpt_scene(width, height, dtype=dtype, ior=1.5)


def _simple_black(width, height, aperture, dtype):
    """The simple_scene sphere data (``src/simple_scene.hpp:18-42``) with a
    BLACK background: the ``new_camera.png`` / ``depth_of_field.png`` goldens
    predate the sky gradient of ``src/main.cpp:116-119`` — their sky is pure
    black, and with the reference's own camera this exact data reproduces
    them (round-3 reconstruction, scripts/recon_search.py)."""
    spheres = [
        (100.0, (0.0, -100.5, -1.0), (0.0, 0.0, 0.0), (0.8, 0.8, 0.0), DIFFUSE),  # ground
        (0.5, (1.0, 0.0, -1.0), (0.0, 0.0, 0.0), (0.999, 0.999, 0.999), SPECULAR),  # right
        (0.5, (-1.0, 0.0, -1.0), (0.0, 0.0, 0.0), (0.999, 0.999, 0.999), DIELECTRIC),  # left
        (0.5, (0.0, 0.0, -1.0), (0.1, 0.1, 0.9), (0.0, 0.7, 0.1), DIFFUSE),  # blue emitter
        (1.0, (1.0, 3.1, -1.0), (30.0, 30.0, 30.0), (0.0, 0.0, 0.0), DIFFUSE),  # light
    ]
    camera = CameraConfig.make(
        position=(-2.0, 2.0, 1.0),
        look_at=(0.0, 0.0, -1.0),
        aspect_ratio=width / height,
        vertical_fov_radians=1.2,
        aperture=aperture,
        dtype=dtype,
    )
    return scene_from_spheres(spheres, camera, dtype=dtype, background=BLACK_BACKGROUND)


@register_scene("new_camera")
def new_camera_scene(width: int, height: int, dtype=torch.float32) -> Scene:
    """Reconstruction of ``samples/new_camera.png`` (retired golden; no scene
    source survives): the simple_scene data + black background at the
    reference camera's own aperture 0.2.  Pooled MAD vs the golden:
    2.19/255 at 512x384@512spp (round 3; cf. box_scene.png 2.5)."""
    return _simple_black(width, height, aperture=0.2, dtype=dtype)


@register_scene("depth_of_field")
def depth_of_field_scene(width: int, height: int, dtype=torch.float32) -> Scene:
    """Reconstruction of ``samples/depth_of_field.png`` (retired golden):
    the SAME scene as new_camera.png with the aperture opened to 0.55 —
    the foreground glass sphere defocuses, the emitter stays near focus.
    Pooled MAD vs the golden: 1.82/255 at 512x384@512spp (round-3 sweep,
    scripts/recon_search.py; round-2's guessed scene sat at 46.5).  Also the
    800x600@256spp benchmark-matrix scene (BASELINE.md)."""
    return _simple_black(width, height, aperture=0.55, dtype=dtype)


@register_scene("random_spheres")
def random_spheres_scene(width: int, height: int, dtype=torch.float32,
                         grid: int = 10, seed: int = 7) -> Scene:
    """Many-sphere stress scene (RTIOW final-scene style): a grid x grid field
    of randomized small spheres around three feature spheres on a giant
    ground.

    The reference never scales past 10 spheres and lists a BVH as unbuilt
    future work (``README.md:8``); this scene (104 spheres at the default
    grid) exercises the brute-force intersect: the per-thread sphere loop
    over the shared-memory table in the CUDA kernel and the broadcast [B,N]
    intersect of the plain path.  It is the many-sphere benchmark scene.
    """
    rng = np.random.default_rng(seed)
    half = grid / 2.0
    spheres = [
        (1000.0, (0.0, -1000.0, 0.0), (0, 0, 0), (0.5, 0.5, 0.5), DIFFUSE),  # ground
        (1.0, (0.0, 1.0, 0.0), (0, 0, 0), (0.999, 0.999, 0.999), DIELECTRIC),
        (1.0, (-4.0, 1.0, 0.0), (0, 0, 0), (0.4, 0.2, 0.1), DIFFUSE),
        (1.0, (4.0, 1.0, 0.0), (0, 0, 0), (0.7, 0.6, 0.5), SPECULAR),
    ]
    for a in range(grid):
        for b in range(grid):
            center = (
                a - half + 0.9 * rng.random(),
                0.2,
                b - half + 0.9 * rng.random(),
            )
            if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) <= 0.9:
                continue
            pick = rng.random()
            if pick < 0.75:
                albedo = (rng.random(3) * rng.random(3)).tolist()
                spheres.append((0.2, center, (0, 0, 0), albedo, DIFFUSE))
            elif pick < 0.95:
                albedo = (0.5 * (1.0 + rng.random(3))).tolist()
                spheres.append((0.2, center, (0, 0, 0), albedo, SPECULAR))
            else:
                spheres.append((0.2, center, (0, 0, 0), (0.999, 0.999, 0.999), DIELECTRIC))
    camera = CameraConfig.make(
        position=(13.0, 2.0, 3.0),
        look_at=(0.0, 0.0, 0.0),
        aspect_ratio=width / height,
        vertical_fov_radians=math.radians(20.0),
        aperture=0.1,
        focus_distance=10.0,
        dtype=dtype,
    )
    return scene_from_spheres(spheres, camera, dtype=dtype)


@register_scene("random_spheres_512")
def random_spheres_512_scene(width: int, height: int, dtype=torch.float32) -> Scene:
    """~520-sphere scaling stress scene (grid=23): 65x the reference's
    largest sphere count, the demonstration workload for the megakernel's
    many-sphere intersect scaling (PERF.md).  Same construction as
    ``random_spheres``, denser grid."""
    return random_spheres_scene(width, height, dtype=dtype, grid=23)


# ---------------------------------------------------------------------------
# Inverse-rendered reconstructions of the two remaining retired goldens
# (``samples/clear_light.png``, ``samples/greenish_party.png``): no scene
# source survives, so the parameters below were RECOVERED against the golden
# images themselves (round 4: derivative-free coordinate search directly on
# the official tonemapped-MAD metric, alternating color / light / sphere-
# geometry waves, anchored on the surviving box_scene.hpp house style —
# light emission ~9 with albedo 1.8, walls as +-0.4 giant spheres; see
# docs/RECONSTRUCTION.md for the method, the forward-model analysis, and
# the per-wave search traces).  Round 5 added a discrete outer search over
# emitter TOPOLOGY (scripts/topology_recon.py): ten fitted configurations
# per scene demonstrated the floor for clear_light (every topology converges
# to the base fit) and bought greenish_party a small real win — the
# registered fit now carries a dim auxiliary emitter BEHIND the camera
# (21.74 -> 21.49 at 512x384@2048).  Pooled MAD vs the goldens:
# clear_light 15.6/255 (round 3: 22.47), greenish_party 21.5/255 (round 3:
# 29.96).  Honest best-effort: the exact originals are likely not uniquely
# identifiable from single clamped LDR images (docs/RECONSTRUCTION.md
# quantifies the residual floor and what it would take to go lower).
# ---------------------------------------------------------------------------

_CLEAR_LIGHT_FIT = {
    "camera": {"position": [0, 0, 2.0], "look_at": [0, 0, -0.4], "up": [0, 1, 0], "vfov": 0.5, "aperture": 0.01, "focus_distance": 2.4, "origin_advance": 0.0},
    "background": [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
    "spheres": [
        {"radius": 1000000.0, "center": [-1000000.4, 0, -1.0], "emission": [0.030604, 0.011936, 0.011018], "albedo": [0.7371, 0.287469, 0.265356], "material": "diffuse"},
        {"radius": 1000000.0, "center": [1000000.4, 0, -1.0], "emission": [0.011842, 0.011842, 0.026315], "albedo": [0.28521, 0.28521, 0.6338], "material": "diffuse"},
        {"radius": 1000000.0, "center": [0, 0, -1000001.0], "emission": [0.025613, 0.025613, 0.024332], "albedo": [0.61688, 0.61688, 0.586036], "material": "diffuse"},
        {"radius": 1000000.0, "center": [0, 1000000.4, -1.0], "emission": [0.009454, 0.021009, 0.007353], "albedo": [0.2277, 0.506, 0.1771], "material": "diffuse"},
        {"radius": 1000000.0, "center": [0, -1000000.4, -1.0], "emission": [0.033959, 0.033959, 0.03328], "albedo": [0.8179, 0.8179, 0.801542], "material": "diffuse"},
        {"radius": 0.247536, "center": [-0.052, 0.0886, -1.16], "emission": [8.0, 8.0, 8.0], "albedo": [1.8, 1.8, 1.8], "material": "diffuse"},
        {"radius": 0.175, "center": [-0.26, -0.266, -0.678], "emission": [0, 0, 0], "albedo": [0.95, 0.95, 0.95], "material": "specular"},
        {"radius": 0.175, "center": [0.14, -0.2244, -0.72], "emission": [0, 0, 0], "albedo": [0.9, 0.35, 0.9], "material": "specular"},
        {"radius": 0.2, "center": [0.21, -0.24, -0.238], "emission": [0, 0, 0], "albedo": [1.0, 1.0, 1.0], "material": "dielectric"},
    ],
}


_GREENISH_PARTY_FIT = {
    "camera": {"position": [0, 0, 1.55], "look_at": [0, 0, -0.4], "up": [0, 1, 0], "vfov": 0.46, "aperture": 0.05, "focus_distance": 1.95, "origin_advance": 0.0},
    "background": [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
    "spheres": [
        {"radius": 1000000.0, "center": [-1000000.4, 0.0, -1.0], "emission": [0.0, 0.0, 0.0], "albedo": [0.288, 0.19584, 0.08064], "material": "diffuse"},
        {"radius": 1000000.0, "center": [1000000.4, 0.0, -1.0], "emission": [0.0, 0.0, 0.0], "albedo": [0.11836, 0.154944, 0.18292], "material": "diffuse"},
        {"radius": 1000000.0, "center": [0.0, 0.0, -1000001.0], "emission": [0.0, 0.0, 0.0], "albedo": [0.3454, 0.628, 0.314], "material": "diffuse"},
        {"radius": 1000000.0, "center": [0.0, 1000000.4, -1.0], "emission": [0.51408, 1.02816, 0.359856], "albedo": [0.7344, 1.4688, 0.51408], "material": "diffuse"},
        {"radius": 1000000.0, "center": [0.0, -1000000.4, -1.0], "emission": [0.0, 0.0, 0.0], "albedo": [0.09, 0.12, 0.093], "material": "diffuse"},
        {"radius": 0.8, "center": [0.0, 1.15, -1.0], "emission": [8.1, 9.0, 7.56], "albedo": [1.8, 1.8, 1.8], "material": "diffuse"},
        {"radius": 0.1054, "center": [-0.18, -0.17, -0.518], "emission": [0, 0, 0], "albedo": [0.95, 0.95, 0.95], "material": "specular"},
        {"radius": 0.15, "center": [0.2, -0.224, -0.48], "emission": [0, 0, 0], "albedo": [1.0, 1.0, 1.0], "material": "dielectric"},
        {"radius": 0.4, "center": [0.0, 0.2, 2.4], "emission": [0.76, 0.76, 0.76], "albedo": [1.8, 1.8, 1.8], "material": "diffuse"},
    ],
}



@register_scene("clear_light")
def clear_light_scene(width: int, height: int, dtype=torch.float32) -> Scene:
    """Inverse-rendered reconstruction of ``samples/clear_light.png`` —
    see the block comment above ``_CLEAR_LIGHT_FIT``."""
    from .io import scene_from_dict

    return scene_from_dict(_CLEAR_LIGHT_FIT, width, height, dtype=dtype)


@register_scene("greenish_party")
def greenish_party_scene(width: int, height: int, dtype=torch.float32) -> Scene:
    """Inverse-rendered reconstruction of ``samples/greenish_party.png`` —
    see the block comment above ``_CLEAR_LIGHT_FIT``."""
    from .io import scene_from_dict

    return scene_from_dict(_GREENISH_PARTY_FIT, width, height, dtype=dtype)
