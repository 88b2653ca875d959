"""One bounce of the port's plain integrator against the JAX package.

The same random rays, state, uniforms and depth go through both
``bounce_step``s.  Float64: every output and aux field within 1e-12
scale-aware.  Float32: the two frameworks' sqrt/rsqrt/sin/cos differ by an
ulp on some rays, so fields agree within 1e-5 scale-aware on >= 99.9% of
rays (a discrete decision can flip on the rest).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu.ops import integrator as jint
from cpu_path_tracing_tpu.render import render_cells_range as jax_render_range
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch.ops import integrator as tint
from cpu_path_tracing_tpu_torch.ops.intersect import intersect_scene
from cpu_path_tracing_tpu_torch.render import render_cells_range

torch.set_num_threads(1)

B = 4096
KW = dict(rr_depth=4, epsilon=1e-4, inf=1e20)
STATE_FIELDS = ("origin", "direction", "throughput", "emission", "alive", "result")
AUX_FIELDS = ("hit", "hid", "thr_pre", "em_h", "sky", "sky_t", "die_miss", "rr_scaled",
              "cont", "was_alive")


def _inputs(name, seed):
    """Random rays from inside the scene's region of interest."""
    rng = np.random.default_rng(seed)
    if name == "box_mirror":  # inside the mirror box (walls at |x|,|y| = 0.4, z = -1)
        o = rng.uniform([-0.38, -0.38, -0.95], [0.38, 0.38, 1.5], (B, 3))
    else:  # open scene: above the ground sphere, around the camera
        o = rng.uniform([-2.5, -0.4, -3.0], [2.5, 3.0, 2.0], (B, 3))
    d = rng.normal(size=(B, 3)) * rng.uniform(0.5, 2.0, (B, 1))
    return dict(o=o, d=d, thr=rng.uniform(0.05, 1.0, (B, 3)), em=rng.uniform(0, 1, (B, 3)),
                alive=rng.random(B) < 0.9, u=rng.random((B, 4)))


def _run_both(name, jd, td, depth, seed=0):
    x = _inputs(name, seed)
    js, ts = pt.get_scene(name, 64, 48, dtype=jd), tp.get_scene(name, 64, 48, dtype=td)
    nd = np.float32 if td == torch.float32 else np.float64
    # Uniforms are float32 draws in both packages, cast to the scene dtype.
    u = x["u"].astype(np.float32).astype(nd)
    jst = jint.RayState(origin=jnp.asarray(x["o"], jd), direction=jnp.asarray(x["d"], jd),
                        throughput=jnp.asarray(x["thr"], jd), emission=jnp.asarray(x["em"], jd),
                        alive=jnp.asarray(x["alive"]), result=jnp.zeros((B, 3), jd))
    tst = tint.RayState(origin=torch.tensor(x["o"], dtype=td),
                        direction=torch.tensor(x["d"], dtype=td),
                        throughput=torch.tensor(x["thr"], dtype=td),
                        emission=torch.tensor(x["em"], dtype=td),
                        alive=torch.tensor(x["alive"]), result=torch.zeros((B, 3), dtype=td))
    jnew, jaux = jint.bounce_step(js, jst, jnp.asarray(u), depth, with_aux=True, **KW)
    tnew, taux = tint.bounce_step(ts, tst, torch.from_numpy(u), depth, with_aux=True, **KW)
    pairs = [(f, np.asarray(getattr(jnew, f)), getattr(tnew, f).numpy()) for f in STATE_FIELDS]
    pairs += [(f, np.asarray(jaux[f]), taux[f].numpy()) for f in AUX_FIELDS]
    return pairs


def _ray_dev(a, b):
    """Per-ray scale-aware deviation |a-b| / max(|a|,|b|,1), max over channels."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    d = np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    return d.reshape(B, -1).max(axis=1)


@pytest.mark.parametrize("depth", [0, 6])
@pytest.mark.parametrize("name", ["box_mirror", "simple"])
def test_bounce_step_f64(name, depth):
    for field, a, b in _run_both(name, jnp.float64, torch.float64, depth):
        assert a.shape == b.shape, field
        assert float(_ray_dev(a, b).max()) < 1e-12, field


@pytest.mark.parametrize("name", ["box_mirror", "simple"])
def test_bounce_step_f32(name):
    for field, a, b in _run_both(name, jnp.float32, torch.float32, 6):
        assert a.shape == b.shape, field
        assert float(np.mean(_ray_dev(a, b) < 1e-5)) >= 0.999, field


def _carry(js):
    """The JAX scene's arrays, copied exactly into a port scene."""
    arrays = {f: np.asarray(getattr(js, f)) for f in
              ("p0", "radius", "anchor_dir", "emission", "albedo", "material", "background")}
    arrays.update({f: np.asarray(getattr(js.camera, f)) for f in
                   ("position", "look_at", "up", "aspect_ratio", "vertical_fov_radians",
                    "aperture", "focus_distance", "origin_advance")})
    return tp.scene_from_arrays(arrays, ior=js.ior)


def test_albedo_gradient_splits_roulette_ties_evenly():
    """Roulette's p = max(albedo) on tied channels (box: white walls, the
    light, two spheres at (1,1,1)).  ``jnp.max`` splits the gradient evenly
    among the ties; the port's autograd must do the same (a nested
    ``torch.maximum`` gave 1/2, 1/4, 1/4).  Autograd of the port's plain
    forward against ``jax.grad`` of the scan path, float64, 1e-9 relative."""
    jcfg = pt.RenderConfig(width=8, height=6, spp=2, max_depth=14, loop="scan",
                           integrator="batch")
    tcfg = tp.RenderConfig(width=8, height=6, spp=2, max_depth=14)
    js = pt.get_scene("box", 8, 6, dtype=jnp.float64)
    ct = np.random.default_rng(2).normal(0, 1, (jcfg.num_cells, 3))
    ids = np.arange(jcfg.num_cells)

    def jloss(albedo):
        sc = dataclasses.replace(js, albedo=albedo)
        return jnp.sum(jax_render_range(sc, jcfg, jnp.asarray(ids), 0, 2) * ct)

    ref = np.asarray(jax.grad(jloss)(js.albedo))
    ts = _carry(js)
    albedo = ts.albedo.clone().requires_grad_(True)
    ts.albedo = albedo
    out = render_cells_range(ts, tcfg, torch.from_numpy(ids), 0, 2)
    (got,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), albedo)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())


def test_lowest_index_wins_ties():
    """Two identical spheres: every hit goes to the lower index, as in the
    reference's strict ``d < t`` scan and the JAX argmin."""
    js = pt.get_scene("simple", 16, 12, dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(js, f)) for f in
              ("p0", "radius", "anchor_dir", "emission", "albedo", "material", "background")}
    arrays.update({f: np.asarray(getattr(js.camera, f)) for f in
                   ("position", "look_at", "up", "aspect_ratio", "vertical_fov_radians",
                    "aperture", "focus_distance", "origin_advance")})
    for f in ("p0", "radius", "anchor_dir", "emission", "albedo", "material"):
        arrays[f] = np.concatenate([arrays[f], arrays[f][3:4]])  # sphere 5 = sphere 3
    ts = tp.scene_from_arrays(arrays, ior=js.ior)
    rng = np.random.default_rng(3)
    target = arrays["p0"][3] - arrays["radius"][3] * arrays["anchor_dir"][3]
    o = np.tile(np.asarray(js.camera.position), (256, 1))
    d = target + rng.normal(0, 0.1, (256, 3)) - o
    t, hid, hit = intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d))
    on_pair = hit.numpy() & np.isin(hid.numpy(), [3, 5])
    assert on_pair.sum() > 100
    assert np.all(hid.numpy()[on_pair] == 3)
    from cpu_path_tracing_tpu.ops.intersect import intersect_scene as jax_intersect
    import cpu_path_tracing_tpu.models.scene as jscene
    jtie = jscene.Scene(**{f: jnp.asarray(arrays[f]) for f in
                           ("p0", "radius", "anchor_dir", "emission", "albedo", "material",
                            "background")}, camera=js.camera, ior=js.ior)
    jt, jhid, _ = jax_intersect(jtie, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(hid.numpy(), np.asarray(jhid))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-13)
