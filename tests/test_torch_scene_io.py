"""The port's scene files (``models/io.py``), case for case with
``tests/test_scene_io.py``, and across packages.

* ``scene_to_dict`` gives the JAX ``scene_to_dict``'s dict, equal, for
  every registered scene.
* A file written by either package loads in the other to the same arrays:
  ``p0`` exactly, and every other field exactly in float64 (both do the
  anchor math in float64 NumPy and cast once).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.models import io as jax_io
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch.models.io import (
    load_scene,
    save_scene,
    scene_from_dict,
    scene_to_dict,
)

torch.set_num_threads(1)

FIELDS = ("p0", "radius", "anchor_dir", "emission", "albedo", "material", "background")
CAMERA = ("position", "look_at", "up", "aspect_ratio", "vertical_fov_radians", "aperture",
          "focus_distance", "origin_advance")


@pytest.mark.parametrize("name", ["simple", "box_mirror", "smallpt", "depth_of_field"])
def test_roundtrip_preserves_params(name):
    scene = tp.get_scene(name, 32, 24)
    back = scene_from_dict(scene_to_dict(scene), 32, 24)
    for f in ("p0", "radius", "anchor_dir", "emission", "albedo", "background"):
        np.testing.assert_allclose(getattr(scene, f).numpy(), getattr(back, f).numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=f)
    assert torch.equal(scene.material, back.material)
    for f in ("position", "look_at", "vertical_fov_radians", "aperture", "focus_distance"):
        np.testing.assert_allclose(getattr(scene.camera, f).numpy(),
                                   getattr(back.camera, f).numpy(), atol=1e-6, err_msg=f)


def test_dict_equals_jax():
    for name in pt.scene_names():
        assert scene_to_dict(tp.get_scene(name, 32, 24)) == \
            jax_io.scene_to_dict(pt.get_scene(name, 32, 24)), name


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32), (jnp.float64, torch.float64)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["box", "smallpt", "depth_of_field"])
def test_files_load_across_packages(tmp_path, name, dtypes, writer):
    jd, td = dtypes
    path = str(tmp_path / "scene.json")
    if writer == "jax":
        jax_io.save_scene(path, pt.get_scene(name, 40, 30, dtype=jd))
    else:
        save_scene(path, tp.get_scene(name, 40, 30, dtype=td))
    ref, got = jax_io.load_scene(path, 40, 30, dtype=jd), load_scene(path, 40, 30, dtype=td)
    assert got.ior == ref.ior
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in CAMERA:
        np.testing.assert_array_equal(getattr(got.camera, f).numpy(),
                                      np.asarray(getattr(ref.camera, f)), err_msg=f)


def test_roundtrip_renders_identically(tmp_path):
    cfg = tp.RenderConfig(width=16, height=12, spp=1, max_depth=8)
    scene = tp.get_scene("box", 16, 12)
    path = str(tmp_path / "box.json")
    save_scene(path, scene)
    loaded = load_scene(path, 16, 12)
    assert torch.equal(tp.render_image(scene, cfg), tp.render_image(loaded, cfg))


def test_json_is_human_editable(tmp_path):
    scene = tp.get_scene("simple", 8, 6)
    d = scene_to_dict(scene)
    assert d["spheres"][0]["material"] == "diffuse"
    # Edit a sphere as a user would.
    d["spheres"][0]["albedo"] = [0.1, 0.2, 0.3]
    edited = scene_from_dict(json.loads(json.dumps(d)), 8, 6)
    np.testing.assert_allclose(edited.albedo[0].numpy(), [0.1, 0.2, 0.3], atol=1e-7)


def test_random_spheres_scene():
    scene = tp.get_scene("random_spheres", 16, 12)
    assert scene.num_spheres >= 90  # grid minus the excluded overlaps
    # Deterministic construction (fixed seed), the JAX package's spheres.
    again = tp.get_scene("random_spheres", 16, 12)
    assert torch.equal(scene.p0, again.p0)
    np.testing.assert_array_equal(scene.p0.numpy(),
                                  np.asarray(pt.get_scene("random_spheres", 16, 12).p0))
    # Renders without error at small size.
    cfg = tp.RenderConfig(width=16, height=12, spp=1, max_depth=6)
    img = tp.render_image(scene, cfg).numpy()
    assert np.isfinite(img).all() and img.max() > 0


def test_cli_scene_file(tmp_path):
    from cpu_path_tracing_tpu_torch.cli import main

    scene = pt.get_scene("box", 16, 12)
    spath = str(tmp_path / "scene.json")
    jax_io.save_scene(spath, scene)  # a file written by the JAX package
    out1, out2 = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    args = ["--width", "16", "--height", "12", "--spp", "1", "--max-depth", "6",
            "--device", "cpu"]
    assert main(["render", "--scene-file", spath, "-o", out1] + args) == 0
    assert main(["render", "--scene", "box", "-o", out2] + args) == 0
    assert open(out1, "rb").read() == open(out2, "rb").read()
