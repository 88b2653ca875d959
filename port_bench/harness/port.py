"""What the benchmark takes from the port: its scene built from a
configuration's data, its render config, and nothing else.  The port is
imported here, inside the functions, so that the harness's other modules
and the reference never load it."""

from __future__ import annotations

import torch


def scene(config: dict, device):
    """The configuration's scene as the port holds it, on ``device``."""
    import cpu_path_tracing_tpu_torch as tp

    sc, cam = config["scene"], config["scene"]["camera"]
    camera = tp.CameraConfig.make(
        position=cam["position"], look_at=cam["look_at"],
        aspect_ratio=config["width"] / config["height"],
        vertical_fov_radians=cam["vertical_fov"], aperture=cam["aperture"],
        focus_distance=cam.get("focus_distance"), up=cam.get("up", (0.0, 1.0, 0.0)),
        origin_advance=cam.get("origin_advance", 0.0), dtype=torch.float32)
    spheres = [(s[0], s[1:4], s[4:7], s[7:10], int(s[10])) for s in sc["spheres"]]
    return tp.scene_from_spheres(spheres, camera, dtype=torch.float32,
                                 background=tuple(map(tuple, sc["background"])),
                                 ior=sc["ior"]).to(device)


def render_config(config: dict, spp: int, seed: int):
    """The port's RenderConfig of the configuration at ``spp`` samples a
    subpixel cell."""
    import cpu_path_tracing_tpu_torch as tp

    return tp.RenderConfig(width=config["width"], height=config["height"], spp=spp,
                           num_subpixels=config["num_subpixels"], max_depth=config["max_depth"],
                           rr_depth=config["rr_depth"], epsilon=config["epsilon"],
                           inf=config["inf"], seed=seed)
