"""One bounce of the port's plain integrator against the JAX package.

The same random rays, state, uniforms and depth go through both
``bounce_step``s.  Float64: every output and aux field within 1e-12
scale-aware.  Float32: the two frameworks' sqrt/rsqrt/sin/cos differ by an
ulp on some rays, so fields agree within 1e-5 scale-aware on >= 99.9% of
rays (a discrete decision can flip on the rest).

Then the closed-form oracles of ``tests/test_integrator.py`` for both loops
of ``radiance`` ('while' and 'scan'): the black enclosure, the furnace
series, the exact sky, roulette with p > 1, no NaN under autograd (with and
without checkpointed bounces), and the scan loop bitwise equal to the while
loop and within 1e-12 of the JAX scan loop.
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
from cpu_path_tracing_tpu_torch.utils.parity import scale_aware

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
    d = scale_aware(a, b)
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


# ---- the closed-form oracles of tests/test_integrator.py, for both loops ----

from cpu_path_tracing_tpu import CameraConfig as JaxCameraConfig  # noqa: E402
from cpu_path_tracing_tpu import DIFFUSE as JAX_DIFFUSE  # noqa: E402
from cpu_path_tracing_tpu import scene_from_spheres as jax_scene_from_spheres  # noqa: E402
from cpu_path_tracing_tpu.ops import rng as jax_rng  # noqa: E402
from cpu_path_tracing_tpu_torch.ops import rng as rng_ops  # noqa: E402


def _keys(n, seed=0):
    return rng_ops.item_keys(seed, torch.arange(n), 0)


def _enclosure(albedo, emission, dtype=torch.float64):
    """A diffuse sphere of radius 10 around the origin (tests/test_integrator.py)."""
    cam = tp.CameraConfig.make((0, 0, 0), (0, 0, -1), 1.0, 0.5, 0.0, dtype=dtype)
    return tp.scene_from_spheres([(10.0, (0.0, 0.0, 0.0), emission, albedo, tp.DIFFUSE)], cam,
                                 anchor_toward=(0.0, 0.0, 0.0), dtype=dtype)


def _down(b, dtype=torch.float64):
    return torch.zeros((b, 3), dtype=dtype), torch.tensor([[0.0, 0.0, -1.0]], dtype=dtype).repeat(b, 1)


@pytest.mark.parametrize("loop", ["while", "scan"])
def test_black_enclosure_single_emission(loop):
    """albedo 0: the path ends after one bounce with exactly the emission."""
    o, d = _down(8)
    out = tint.radiance(_enclosure((0.0, 0.0, 0.0), (1.0, 2.0, 3.0)), o, d, _keys(8),
                        max_depth=50, loop=loop)
    np.testing.assert_allclose(out.numpy(), np.tile([1.0, 2.0, 3.0], (8, 1)), atol=1e-12)


@pytest.mark.parametrize("loop", ["while", "scan"])
def test_furnace_geometric_series(loop):
    """Emissive enclosure with albedo a: E[L] = e / (1 - a) (emission before
    roulette, src/main.cpp:126-137; roulette keeps it unbiased).  4000
    paths, ~4 sigma."""
    a, e, b = 0.5, 0.3, 4000
    o, d = _down(b)
    out = tint.radiance(_enclosure((a, a, a), (e, e, e)), o, d, _keys(b), max_depth=200,
                        loop=loop).numpy()
    stderr = out.std() / np.sqrt(b * 3)
    assert abs(out.mean() - e / (1 - a)) < max(4 * stderr, 0.01)


@pytest.mark.parametrize("loop", ["while", "scan"])
def test_sky_gradient_exact(loop):
    """A ray that misses everything returns the sky gradient (src/main.cpp:115-120)."""
    cam = tp.CameraConfig.make((0, 0, 0), (0, 0, -1), 1.0, 0.5, 0.0, dtype=torch.float64)
    sc = tp.scene_from_spheres([(0.5, (0.0, 0.0, 100.0), (0, 0, 0), (1, 1, 1), tp.DIFFUSE)], cam,
                               anchor_toward=(0, 0, 99), dtype=torch.float64)
    d_raw = np.array([[0.0, 1.0, -1.0], [0.0, -2.0, -2.0], [1.0, 0.0, 0.0]])
    out = tint.radiance(sc, torch.zeros((3, 3), dtype=torch.float64), torch.from_numpy(d_raw),
                        _keys(3), max_depth=10, loop=loop).numpy()
    for i in range(3):
        t = 0.5 * (d_raw[i][1] / np.linalg.norm(d_raw[i]) + 1.0)
        np.testing.assert_allclose(out[i], (1 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0]),
                                   atol=1e-12)


@pytest.mark.parametrize("loop", ["while", "scan"])
def test_rr_p_above_one_never_kills(loop):
    """albedo 1.92 (the disco light): survival p > 1, so roulette only damps
    by 1/p and every path lives to max_depth with the same radiance."""
    a, md = 1.92, 30
    o, d = _down(64)
    out = tint.radiance(_enclosure((a, a, a), (1.0, 1.0, 1.0)), o, d, _keys(64), max_depth=md,
                        rr_depth=4, loop=loop).numpy()
    thr, expect = 1.0, 0.0
    for k in range(md):
        expect += thr
        thr *= a if k <= 4 else 1.0
    np.testing.assert_allclose(out, expect, rtol=1e-10)
    assert out.std() < 1e-12


def test_scan_equals_while_and_the_jax_scan():
    """The scan loop bitwise equal to the while loop, both within 1e-12 of
    the JAX package's scan loop on the same rays; live_per_depth sums to the
    while loop's segments."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(256, 3))
    kw = dict(max_depth=64, rr_depth=4)
    sc = _enclosure((0.5, 0.6, 0.7), (0.2, 0.1, 0.05))
    o = torch.zeros((256, 3), dtype=torch.float64)
    a, st_a = tint.radiance(sc, o, torch.from_numpy(d), _keys(256), loop="while",
                            with_stats=True, **kw)
    b, st_b = tint.radiance(sc, o, torch.from_numpy(d), _keys(256), loop="scan",
                            with_stats=True, **kw)
    assert torch.equal(a, b)
    assert int(st_b["segments"]) == st_a["segments"] and st_b["live_per_depth"].shape == (64,)
    jcam = JaxCameraConfig.make((0, 0, 0), (0, 0, -1), 1.0, 0.5, 0.0, dtype=jnp.float64)
    js = jax_scene_from_spheres([(10.0, (0.0, 0.0, 0.0), (0.2, 0.1, 0.05), (0.5, 0.6, 0.7),
                                  JAX_DIFFUSE)], jcam, anchor_toward=(0.0, 0.0, 0.0),
                                dtype=jnp.float64)
    jkeys = jax_rng.item_keys(0, jnp.arange(256, dtype=jnp.int32), 0)
    ref = jint.radiance(js, jnp.zeros((256, 3), jnp.float64), jnp.asarray(d), jkeys, loop="scan",
                        **kw)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("loop", ["while", "scan"])
@pytest.mark.parametrize("remat", [False, True])
def test_no_nans_under_grad(loop, remat):
    """Gradients of the summed radiance with respect to p0, radius, albedo
    and emission are finite in float32 (masked miss and dead rays must not
    poison the backward), with and without checkpointed bounces."""
    sc = _enclosure((0.5, 0.5, 0.5), (0.3, 0.3, 0.3), dtype=torch.float32)
    leaves = [getattr(sc, f).clone().requires_grad_(True)
              for f in ("p0", "radius", "albedo", "emission")]
    sc.p0, sc.radius, sc.albedo, sc.emission = leaves
    d = torch.from_numpy(np.random.default_rng(4).normal(size=(32, 3)).astype(np.float32))
    out = tint.radiance(sc, torch.zeros((32, 3)), d, _keys(32), max_depth=8, loop=loop,
                        remat=remat)
    for g in torch.autograd.grad(out.sum(), leaves):
        assert bool(torch.isfinite(g).all())
