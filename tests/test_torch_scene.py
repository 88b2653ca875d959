"""The port's scenes, camera and host-to-kernel packs against the JAX package.

Sphere arrays come from float64 NumPy in both packages and are then cast,
so they must be equal exactly.  The camera frame passes through tan, norm
and rsqrt in each framework: within 2 ulp of each vector's scale in
float32, 1e-14 in float64.  ``pack_scene`` is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.models.camera import build_camera as jax_build_camera
from cpu_path_tracing_tpu.ops.pallas.megakernel import pack_camera as jax_pack_camera
from cpu_path_tracing_tpu.ops.pallas.megakernel import pack_scene as jax_pack_scene
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch.models.camera import FIELDS as CAMERA_FIELDS
from cpu_path_tracing_tpu_torch.ops.kernels.megakernel import pack_camera, pack_scene

torch.set_num_threads(1)

DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]
SPHERE_FIELDS = ("p0", "radius", "anchor_dir", "emission", "albedo", "material", "background")
FRAME_FIELDS = ("position", "lower_left", "cam_x", "cam_y", "lens_radius", "origin_advance")


def test_same_registry():
    assert tp.scene_names() == pt.scene_names()
    assert len(tp.scene_names()) == 12  # 11 scenes and the disco_sphere alias of box_mirror


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", pt.scene_names())
def test_sphere_arrays_equal(name, dtypes):
    jd, td = dtypes
    js, ts = pt.get_scene(name, 64, 48, dtype=jd), tp.get_scene(name, 64, 48, dtype=td)
    assert ts.ior == js.ior
    for f in SPHERE_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def _within(b, a, tol):
    scale = np.max(np.abs(a)) if a.ndim else np.abs(a)
    assert np.max(np.abs(b - a)) <= tol(scale), (a, b)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", pt.scene_names())
def test_camera_and_pack_camera(name, dtypes):
    jd, td = dtypes
    js, ts = pt.get_scene(name, 64, 48, dtype=jd), tp.get_scene(name, 64, 48, dtype=td)
    if td == torch.float32:
        def tol(scale):
            return 2 * np.spacing(np.float32(max(scale, 1e-30)))
    else:
        def tol(scale):
            return 1e-14 * max(scale, 1.0)
    for f in CAMERA_FIELDS:
        _within(getattr(ts.camera, f).numpy(), np.asarray(getattr(js.camera, f)), tol)
    jc, tc = jax_build_camera(js.camera), tp.build_camera(ts.camera)
    for f in FRAME_FIELDS:
        _within(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), tol)
    if td == torch.float32:
        # The kernel's [20] camera vector, element by element.
        ref = np.asarray(jax_pack_camera(js))
        got = pack_camera(ts).numpy()
        assert got.dtype == ref.dtype == np.float32
        assert np.all(np.abs(got - ref) <= 2 * np.spacing(np.abs(ref)))


@pytest.mark.parametrize("name", pt.scene_names())
def test_pack_scene_bitwise(name):
    ref = np.asarray(jax_pack_scene(pt.get_scene(name, 64, 48, dtype=jnp.float32)))
    got = pack_scene(tp.get_scene(name, 64, 48)).numpy()
    assert got.shape == ref.shape and got.shape[1] == 17
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "f64"])
def test_scene_from_arrays_round_trip(dtypes):
    jd, td = dtypes
    js = pt.get_scene("smallpt_exact", 40, 30, dtype=jd)
    arrays = {f: np.asarray(getattr(js, f)) for f in SPHERE_FIELDS}
    arrays.update({f: np.asarray(getattr(js.camera, f)) for f in CAMERA_FIELDS})
    ts = tp.scene_from_arrays(arrays, ior=js.ior)
    own = tp.get_scene("smallpt_exact", 40, 30, dtype=td)
    assert ts.ior == own.ior == 1.5
    for f in SPHERE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), arrays[f], err_msg=f)
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(getattr(ts.camera, f).numpy(), arrays[f], err_msg=f)
    np.testing.assert_array_equal(pack_scene(ts, td).numpy(), pack_scene(own, td).numpy())
    with pytest.raises(KeyError, match="background"):
        tp.scene_from_arrays({k: v for k, v in arrays.items() if k != "background"}, ior=1.5)


def test_scene_to_moves_every_buffer():
    ts = tp.get_scene("box", 8, 6).to(torch.float64)
    assert ts.p0.dtype == torch.float64 and ts.camera.position.dtype == torch.float64
    assert ts.material.dtype == torch.int32  # integer buffers keep their dtype
    names = {n for n, _ in ts.named_buffers()}
    assert {"p0", "background", "camera.look_at", "camera.focus_distance"} <= names
