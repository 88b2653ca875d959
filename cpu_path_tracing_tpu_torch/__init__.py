"""cpu_path_tracing_tpu_torch — the path tracer on PyTorch and CUDA.

The port of ``cpu_path_tracing_tpu`` (JAX, Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100.  Module names mirror the JAX
package's.  The forward render is ported: ``render_image`` renders where
the scene lives, with the CUDA kernel (``ops/kernels/megakernel.py``,
``csrc/``) on the card and its plain PyTorch version on the CPU.  So is
inverse rendering of every optimizable field (``grad.py``): sphere
centers and radii, albedo, emission, the camera and the background.  Its
backward is the analytic replay for albedo, emission and background
(``ops/replay.py``; on the card the CUDA kernel of
``ops/kernels/replay.py`` where it takes the scene), else autograd through
the batch route's bounce loop (``ops/integrator.py``).  The single-process
host runtime is ported too: tiled, retried and resumable renders
(``orchestrator.py``), progressive and inverse-run checkpoints
(``utils/checkpoint.py``), scene files (``models/io.py``), the NaN guard
(``utils/debug.py``), the native image writers (``utils/native.py``) and the
benchmark suite (``cli bench --suite``).  So are the mesh and multi-process
paths (``parallel/``: sharded renders and inverse steps over a mesh of
devices, multi-process renders on ``torch.distributed``) and ``entry.py``.
This package never imports JAX or the JAX package.
"""

from .config import RenderConfig
from .models.camera import Camera, CameraConfig, build_camera, get_rays
from .models.scene import (
    DIELECTRIC,
    DIFFUSE,
    SPECULAR,
    Scene,
    get_scene,
    params_from_arrays,
    register_scene,
    scene_from_arrays,
    scene_from_spheres,
    scene_names,
)
from .models import scenes as _builtin_scenes  # noqa: F401  (registers the scenes)
from .render import finalize_image, render_cells, render_image
from .utils.image import color_to_int, tonemap, write_png, write_ppm

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "CameraConfig",
    "build_camera",
    "get_rays",
    "DIFFUSE",
    "SPECULAR",
    "DIELECTRIC",
    "Scene",
    "get_scene",
    "params_from_arrays",
    "register_scene",
    "scene_from_arrays",
    "scene_from_spheres",
    "scene_names",
    "render_image",
    "render_cells",
    "finalize_image",
    "color_to_int",
    "tonemap",
    "write_png",
    "write_ppm",
]
