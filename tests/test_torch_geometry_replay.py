"""The geometry replay (the p0, radius and camera backward of
``ops/geometry_replay.py`` and the plain version of its CUDA kernel) on the
CPU.

Each hand-written bounce VJP is held to ``torch.autograd`` of
``bounce_step`` in float64 (1e-12 of the largest magnitude), for each
material and for a tangent ray and a tangent refraction; the plain geometry
replay to the port's scan VJP (float64, max_depth 8 and 100) and to
``jax.grad`` of the JAX package's loss (max_depth 8, as its own tests run
it), 1e-9 relative with atol 1e-9 of each field's largest magnitude; in
float32 to float32 autograd within 1e-4.  Scenes are 16x12 at 2 spp.  Exact
ties of roots (simple with every sphere twice, and with one sphere three
times) are held to the scan VJP and ``jax.grad`` by the same tolerance; on
scenes without a tie the split changes no bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_path_tracing_tpu as pt
from cpu_path_tracing_tpu import grad as jgrad
from cpu_path_tracing_tpu.render import render_cells as jax_render_cells
import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import grad
from cpu_path_tracing_tpu_torch.models.camera import FIELDS as CAMERA_FIELDS
from cpu_path_tracing_tpu_torch.models.camera import build_camera
from cpu_path_tracing_tpu_torch.models.scene import Scene
from cpu_path_tracing_tpu_torch.ops import geometry_replay as gr
from cpu_path_tracing_tpu_torch.ops.integrator import bounce_step, init_state
from cpu_path_tracing_tpu_torch.ops.kernels import geometry_replay as gk
from cpu_path_tracing_tpu_torch.ops.kernels import megakernel as mk
from cpu_path_tracing_tpu_torch.ops.materials import sample_dielectric_c
from cpu_path_tracing_tpu_torch.render import render_cells_range

torch.set_num_threads(1)

W, H, SPP = 16, 12, 2
GEOMETRY_FIELDS = ("p0", "radius", "camera")
KW = dict(rr_depth=4, epsilon=1e-4, inf=1e20)


def _with_spheres(scene, **fields):
    """``scene`` with some sphere fields replaced."""
    f = {k: getattr(scene, k) for k in ("p0", "radius", "anchor_dir", "emission", "albedo",
                                        "material", "background")}
    f.update(fields)
    return Scene(**f, camera=scene.camera, ior=scene.ior)


def _autograd_bounce(scene, o, d, u, go, gd):
    """Autograd of sum(go . origin' + gd . direction') over the rays that
    continue, with respect to o, d, p0 and radius; and the aux."""
    leaves = [x.clone().requires_grad_(True) for x in (o, d, scene.p0, scene.radius)]
    sc = _with_spheres(scene, p0=leaves[2], radius=leaves[3])
    new, aux = bounce_step(sc, init_state(leaves[0], leaves[1]), u, 0, with_aux=True, **KW)
    cont = aux["cont"][:, None]
    total = (torch.where(cont, go * new.origin, 0.0) + torch.where(cont, gd * new.direction,
                                                                   0.0)).sum()
    return torch.autograd.grad(total, leaves), aux


def _hand_bounce(scene, o, d, u, go, gd, aux):
    """The hand-written VJP on the continuing rays, scattered back."""
    c = aux["cont"]
    hid = aux["hid"][c]
    fw = gr.bounce_forward(scene, o[c], d[c], hid, u[c], epsilon=KW["epsilon"], inf=KW["inf"])
    g_o, g_d, g_p0, g_r, _ = gr.bounce_vjp(fw, go[c], gd[c])
    onehot = (hid[:, None] == torch.arange(scene.num_spheres)[None, :]).double()
    full_o, full_d = torch.zeros_like(o), torch.zeros_like(d)
    full_o[c], full_d[c] = g_o, g_d
    return full_o, full_d, onehot.T @ g_p0, onehot.T @ g_r, fw


def _assert_close_scaled(got, ref, tol):
    for g, r in zip(got, ref):
        scale = float(r.abs().max())
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=tol * max(scale, 1e-300))


@pytest.mark.parametrize("material", [0, 1, 2], ids=["diffuse", "specular", "dielectric"])
def test_bounce_vjp_matches_autograd(material):
    """Random rays against simple's spheres, every sphere of one material,
    a third of the origins inside a sphere (back faces: the dielectric's
    index 2 side): the VJP of the continuing rays' next origin and direction
    within 1e-12 of the largest magnitude of autograd's, for o, d, p0 and
    radius."""
    scene = tp.get_scene("simple", W, H, dtype=torch.float64)
    scene = _with_spheres(scene, material=torch.full_like(scene.material, material))
    rng = np.random.default_rng(material)
    b = 3000
    centers = (scene.p0 - scene.radius[:, None] * scene.anchor_dir).numpy()
    radii = scene.radius.numpy()
    j = rng.integers(0, scene.num_spheres, b)
    inside = rng.random(b) < 1 / 3
    cam = scene.camera.position.numpy()
    o = np.where(inside[:, None], centers[j] + rng.normal(0, 0.3, (b, 3)) * radii[j, None] * 0.5,
                 cam + rng.normal(0, 0.2, (b, 3)))
    aim = centers[j] + rng.normal(0, 1, (b, 3)) * radii[j, None] * 0.8
    d = np.where(inside[:, None], rng.normal(0, 1, (b, 3)), aim - o)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    u = torch.from_numpy(rng.random((b, 4)))
    go, gd = torch.from_numpy(rng.normal(0, 1, (b, 3))), torch.from_numpy(rng.normal(0, 1, (b, 3)))
    ref, aux = _autograd_bounce(scene, o, d, u, go, gd)
    *got, fw = _hand_bounce(scene, o, d, u, go, gd, aux)
    assert int(aux["cont"].sum()) > 1000
    if material == 2:
        refl = fw.dielectric.reflected
        assert int(refl.sum()) > 50 and int((~refl).sum()) > 50
        assert int((fw.fsign < 0).sum()) > 50
    if material == 0:
        assert int(fw.diffuse.ax_y.sum()) > 50 and int((~fw.diffuse.ax_y).sum()) > 50
    _assert_close_scaled(got, ref, 1e-12)


@pytest.mark.parametrize("material", [0, 1, 2], ids=["diffuse", "specular", "dielectric"])
def test_tangent_ray_vjp_is_finite_and_matches_autograd(material):
    """A ray that grazes a sphere exactly (disc == 0, a double root, the hit
    normal perpendicular to the ray): PR 7's guard gives sqrt's derivative
    0 there, the tie of r1 and r2 splits t's evenly, and the hand-written VJP
    is finite and equal to autograd's."""
    one = torch.ones(1, dtype=torch.float64)
    base = tp.get_scene("simple", W, H, dtype=torch.float64)
    scene = _with_spheres(base, p0=torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64),
                          radius=one.clone(),
                          anchor_dir=torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64),
                          emission=torch.zeros(1, 3, dtype=torch.float64),
                          albedo=torch.full((1, 3), 0.5, dtype=torch.float64),
                          material=torch.tensor([material], dtype=torch.int32))
    o = torch.tensor([[0.0, 1.0, -5.0]], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    u = torch.tensor([[0.3, 0.7, 0.4, 0.0]], dtype=torch.float64)
    go = torch.tensor([[0.3, -1.1, 0.7]], dtype=torch.float64)
    gd = torch.tensor([[-0.4, 0.9, 1.3]], dtype=torch.float64)
    ref, aux = _autograd_bounce(scene, o, d, u, go, gd)
    *got, fw = _hand_bounce(scene, o, d, u, go, gd, aux)
    assert bool(aux["cont"][0]) and bool(fw.root.tangent[0]) and float(fw.root.w1[0]) == 0.5
    _assert_close_scaled(got, ref, 1e-12)


def test_tangent_refraction_vjp_is_finite_and_matches_autograd():
    """A refraction that leaves exactly tangent (kk == 0 at the critical
    angle, from inside, index 2): the refraction's VJP takes sqrt's
    derivative as 0, as the scan VJP's guard does, and matches autograd of
    ``sample_dielectric_c``."""
    n = torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64)
    front = torch.tensor([False])
    u_a = torch.tensor([0.5], dtype=torch.float64)
    base = float(np.sqrt(0.75))
    for k in range(-4, 5):
        d = torch.tensor([[0.5, -(base + k * np.spacing(base)), 0.0]], dtype=torch.float64)
        f = gr.dielectric_forward(d, n, front, u_a, 2.0)
        if bool(f.zero_k[0]) and not bool(f.reflected[0]):
            break
    else:
        pytest.fail("no exactly tangent refraction near the critical angle")
    g = torch.tensor([[0.7, -0.2, 1.1]], dtype=torch.float64)
    dl, nl = d.clone().requires_grad_(True), n.clone().requires_grad_(True)
    x, y, z = dl[:, 0], dl[:, 1], dl[:, 2]
    out = sample_dielectric_c(x, y, z, x * x + y * y + z * z, nl[:, 0], nl[:, 1], nl[:, 2], front,
                              u_a, ior=2.0, spx=x, spy=y, spz=z)
    ref = torch.autograd.grad((torch.stack(out[:3], dim=-1) * g).sum(), (dl, nl))
    _assert_close_scaled(gr.refract_vjp(f, g), ref, 1e-12)


def _plain_grads(scene, cfg, ct):
    """The plain geometry replay's gradients of sum(ct * render sum)."""
    dt = scene.dtype
    part, st = gk.geometry_replay(mk.pack_scene(scene, dt), mk.pack_camera(scene, dt), (0, 0),
                                  ct.to(dt), cfg=cfg, n_cells=cfg.num_cells,
                                  n_items=cfg.spp * cfg.num_cells, ior=scene.ior)
    return dict(zip(*grad.flatten_params(gr.geometry_grads_from_partials(scene, part)))), st


def _scan_grads(scene, cfg, ct):
    """The port's scan VJP ('scan' route) of sum(ct * render sum)."""
    span = grad._Span(scene, cfg, cfg.spp, 1, True, False)
    names, values = grad.flatten_params(grad.split_params(scene, GEOMETRY_FIELDS))
    return dict(zip(names, grad._scan_vjp(span, torch.arange(cfg.num_cells), 0, names, values,
                                          ct)))


def _assert_fields_close(got, ref, rtol, atol_rel):
    """Each field within rtol and atol_rel of its largest magnitude."""
    assert set(got) == set(ref)
    for field in GEOMETRY_FIELDS:
        names = [n for n in ref if n.split(".")[0] == field]
        scale = max(float(ref[n].abs().max()) for n in names)
        for n in names:
            np.testing.assert_allclose(got[n].double().numpy(), ref[n].double().numpy(),
                                       rtol=rtol, atol=atol_rel * scale, err_msg=n)


@pytest.mark.parametrize("name,depth", [("simple", 8), ("simple", 100), ("box_mirror", 8),
                                        ("box_mirror", 100)])
def test_plain_replay_matches_scan_vjp(name, depth):
    """Float64, 16x12, 2 spp, a seeded normal cotangent: the plain geometry
    replay's p0, radius and camera gradients within 1e-9 relative (atol 1e-9
    of each field's largest magnitude) of the port's scan VJP."""
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=depth)
    scene = tp.get_scene(name, W, H, dtype=torch.float64)
    ct = torch.from_numpy(np.random.default_rng(depth).normal(0, 1, (cfg.num_cells, 3)))
    got, st = _plain_grads(scene, cfg, ct)
    ref = _scan_grads(scene, cfg, ct)
    _assert_fields_close(got, ref, 1e-9, 1e-9)
    if name != "box_mirror":
        assert st["missed"] > 0 and st["sweep_bounces"] > 0
        assert float(got["p0"].abs().max()) > 0 and float(got["camera.look_at"].abs().max()) > 0


def test_plain_replay_box_geometry_is_exactly_zero():
    """No path of the closed box reaches the background: every p0, radius
    and camera partial is exactly 0, as the scan VJP's p0 and radius are;
    on simple the camera's origin_advance gradient is below 1e-12 of the
    camera's scale (it moves each ray's origin along its own direction)."""
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=100)
    ct = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (cfg.num_cells, 3)))
    box = tp.get_scene("box", W, H, dtype=torch.float64)
    part, st = gk.geometry_replay(mk.pack_scene(box, torch.float64),
                                  mk.pack_camera(box, torch.float64), (0, 0), ct, cfg=cfg,
                                  n_cells=cfg.num_cells, n_items=SPP * cfg.num_cells,
                                  ior=box.ior)
    assert st["missed"] == 0 and bool((part == 0).all())
    got, _ = _plain_grads(tp.get_scene("simple", W, H, dtype=torch.float64), cfg, ct)
    scale = max(float(got[f"camera.{f}"].abs().max()) for f in CAMERA_FIELDS)
    assert abs(float(got["camera.origin_advance"])) < 1e-12 * scale


@pytest.mark.parametrize("name", ["simple", "box_mirror"])
def test_plain_replay_matches_jax_grad(name):
    """``jax.grad`` of the JAX package's ``cell_loss`` (the scan loop, its
    tests' way, on the CPU) with respect to p0, radius and the camera, on
    the same scene, config, seed and target: the plain geometry replay with
    the loss's cotangent within 1e-9 relative (atol 1e-9 of each field's
    largest magnitude)."""
    jcfg = pt.RenderConfig(width=W, height=H, spp=SPP, max_depth=8, loop="scan")
    js = pt.get_scene(name, W, H, dtype=jnp.float64)
    ids = jnp.arange(jcfg.num_cells, dtype=jnp.int32)
    target = jax_render_cells(js, jcfg, ids) * 0.9
    jg = jax.grad(jgrad.cell_loss)(jgrad.split_params(js, GEOMETRY_FIELDS), js, jcfg, ids, target)
    ref = {"p0": torch.from_numpy(np.array(jg["p0"])),
           "radius": torch.from_numpy(np.array(jg["radius"])),
           **{f"camera.{f}": torch.from_numpy(np.array(getattr(jg["camera"], f)))
              for f in CAMERA_FIELDS}}
    arrays = {f: np.asarray(getattr(js, f)) for f in ("p0", "radius", "anchor_dir", "emission",
                                                       "albedo", "material", "background")}
    arrays["camera"] = {f: np.asarray(getattr(js.camera, f)) for f in CAMERA_FIELDS}
    ts = tp.scene_from_arrays(arrays, ior=js.ior)
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
    cells = render_cells_range(ts, cfg, torch.arange(cfg.num_cells), 0, SPP) / SPP
    ct = 2.0 * (cells - torch.from_numpy(np.array(target))) / (SPP * cells.numel())
    got, _ = _plain_grads(ts, cfg, ct)
    if name == "box_mirror":  # closed: no miss, every geometry gradient 0 in both
        assert all(float(v.abs().max()) == 0.0 for v in ref.values())
        assert all(float(v.abs().max()) == 0.0 for v in got.values())
        return
    _assert_fields_close(got, ref, 1e-9, 1e-9)


def test_float32_plain_replay_matches_float32_autograd():
    """Float32 rays: the plain geometry replay (float32 forward, float64
    adjoints) against the scan VJP in float32 autograd, which runs the same
    float32 forward: each field within 1e-4 of its largest magnitude."""
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
    scene = tp.get_scene("simple", W, H)
    ct = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (cfg.num_cells, 3))
                          .astype(np.float32))
    got, _ = _plain_grads(scene, cfg, ct)
    ref = _scan_grads(scene, cfg, ct)
    _assert_fields_close(got, ref, 0.0, 1e-4)


def test_partials_layout_and_grads_from_partials():
    """The ``[4N+14]`` layout: p0 sphere-major, radius, then the 14 camera
    floats in ``pack_camera``'s order; the camera block maps to the eight
    ``CameraConfig`` leaves as autograd of those floats through
    ``build_camera``."""
    scene = tp.get_scene("simple", W, H, dtype=torch.float64)
    n = scene.num_spheres
    assert gr.n_geometry_partials(n) == 4 * n + 14
    blocks = gr.geometry_partial_blocks(n)
    assert [(s.start, s.stop) for s in blocks.values()] == [(0, 3 * n), (3 * n, 4 * n),
                                                           (4 * n, 4 * n + 14)]
    packed = mk.pack_camera(scene, torch.float64)
    cam_floats = torch.cat([packed[0:13], packed[19:20]])
    assert torch.equal(cam_floats, torch.cat([*build_camera(scene.camera)[:4],
                                              build_camera(scene.camera)[4].reshape(1),
                                              build_camera(scene.camera)[5].reshape(1)]))
    rng = np.random.default_rng(0)
    part = torch.from_numpy(rng.normal(0, 1, 4 * n + 14))
    g = gr.geometry_grads_from_partials(scene, part)
    assert torch.equal(g["p0"], part[:3 * n].reshape(n, 3))
    assert torch.equal(g["radius"], part[3 * n:4 * n])
    leaves = {f: getattr(scene.camera, f).clone().requires_grad_(True) for f in CAMERA_FIELDS}
    cam = build_camera(tp.CameraConfig(**leaves))
    flat = torch.cat([cam.position, cam.lower_left, cam.cam_x, cam.cam_y,
                      cam.lens_radius.reshape(1), cam.origin_advance.reshape(1)])
    ref = torch.autograd.grad((flat * part[4 * n:]).sum(), list(leaves.values()),
                              materialize_grads=True, allow_unused=True)
    for f, r in zip(CAMERA_FIELDS, ref):
        np.testing.assert_allclose(getattr(g["camera"], f).numpy(), r.numpy(), rtol=1e-14,
                                   atol=1e-14, err_msg=f)
    assert float(g["camera"].origin_advance) == float(part[-1])


def _stub(device, dtype=torch.float32, n=8):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, num_spheres=n)


def test_backward_route_table():
    """'geometry' only for a CUDA scene the kernels take (a stub device: no
    launch), with replay on and a geometry field; 'replay' for replay-only
    fields; 'scan' for the CPU, float64, tent jitter, more than 40 spheres
    and replay off (``--no-replay-backward``)."""
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP)
    geo = ("p0", "radius", "albedo", "camera")
    route = grad.backward_route
    assert route(_stub("cuda"), cfg, geo) == "geometry"
    assert route(_stub("cuda"), cfg, ("camera",)) == "geometry"
    assert route(_stub("cuda"), cfg, geo, replay=False) == "scan"
    assert route(_stub("cuda"), cfg, ("albedo", "emission"), replay=False) == "scan"
    assert route(_stub("cpu"), cfg, geo) == "scan"
    assert route(_stub("cuda", torch.float64), cfg, geo) == "scan"
    assert route(_stub("cuda"), cfg.replace(jitter="tent"), geo) == "scan"
    assert route(_stub("cuda", n=41), cfg, geo) == "scan"
    assert route(_stub("cuda", n=40), cfg, geo) == "geometry"
    for dev in ("cpu", "cuda"):
        assert route(_stub(dev), cfg, ("albedo", "emission", "background")) == "replay"
    scene = tp.get_scene("simple", W, H)
    assert grad.make_diff_render(scene, cfg).span.route(geo) == "scan"


def test_geometry_grads_leave_the_camera_out_when_it_is_no_field(monkeypatch):
    """Without the camera the partials' p0 and radius come out as they are,
    and no autograd pass through ``build_camera`` runs."""
    scene = tp.get_scene("simple", W, H, dtype=torch.float64)
    n = scene.num_spheres
    part = torch.from_numpy(np.random.default_rng(1).normal(0, 1, 4 * n + 14))
    full = gr.geometry_grads_from_partials(scene, part)
    monkeypatch.setattr(torch.autograd, "grad", lambda *a, **k: pytest.fail("camera mapped"))
    g = gr.geometry_grads_from_partials(scene, part, camera=False)
    assert set(g) == {"p0", "radius"}
    assert torch.equal(g["p0"], full["p0"]) and torch.equal(g["radius"], full["radius"])


def test_a_geometry_step_without_the_camera_is_bitwise_as_with_its_map(monkeypatch):
    """One step of the geometry route (its plain versions) over p0, radius,
    albedo and emission: the same loss, first gradient and params whether
    the K7 wrapper maps the camera's partials or leaves them out."""
    monkeypatch.setattr(grad, "backward_route", lambda *a, **k: "geometry")
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
    scene = tp.get_scene("box", W, H)
    target = grad.render_target(scene, cfg) * 0.9
    start = {k: v + 0.01 for k, v in
             grad.split_params(scene, ("p0", "radius", "albedo", "emission")).items()}

    def one_step():
        step = grad.make_accum_train_step(scene, cfg, 1e-2, cell_chunk=400)
        params, loss = step(start, target)
        moments = [s["exp_avg"] for s in step.state_dict()["optimizer"]["state"].values()]
        return [loss, *grad.flatten_params(params)[1], *moments]

    got = one_step()
    kernel = grad.geometry_param_grads_kernel
    monkeypatch.setattr(grad, "geometry_param_grads_kernel",
                        lambda *a, camera: kernel(*a, camera=True))
    want = one_step()
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_geometry_route_on_plain_versions_matches_scan(monkeypatch):
    """The 'geometry' route's wiring, run on the CPU where both kernels'
    wrappers take their plain versions: a float64 step's loss and every
    gradient (p0, radius, albedo, emission, the camera's leaves) within
    1e-9 relative (atol 1e-9 of each field's largest magnitude) of the
    'scan' route's, over two cell chunks.  Albedo is
    moved off simple's exact zero channel, where the replay's guarded
    division gives 0 and autograd the albedo-excluded product
    (``ops/replay.py``)."""
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=16)
    scene = tp.get_scene("simple", W, H, dtype=torch.float64)
    target = grad.render_target(scene, cfg) * 0.9
    fields = ("p0", "radius", "albedo", "emission", "camera")
    params = grad.split_params(scene, fields)
    params["albedo"] = params["albedo"] + 0.01
    loss0, ref = grad.make_accum_loss_grad(scene, cfg, cell_chunk=400)(params, target)
    monkeypatch.setattr(grad, "backward_route", lambda *a, **k: "geometry")
    calls = []
    plain = gk.geometry_replay_reference

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(gk, "geometry_replay_reference", counted)
    loss1, got = grad.make_accum_loss_grad(scene, cfg, cell_chunk=400)(params, target)
    assert len(calls) == 2 and torch.equal(loss0, loss1)
    ref, got = (dict(zip(*grad.flatten_params(g))) for g in (ref, got))
    for field in fields:
        names = [n for n in ref if n.split(".")[0] == field]
        scale = max(float(ref[n].abs().max()) for n in names)
        assert scale > 0, field
        for n in names:
            np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), rtol=1e-9,
                                       atol=1e-9 * scale, err_msg=n)


# Tie scenes: simple with every sphere duplicated, and simple with its
# right sphere (index 1) three times.  A copy's roots equal the original's
# bit for bit, so every hit on it ties exactly.
TIE_SCENES = {"duplicated": [0, 1, 2, 3, 4, 0, 1, 2, 3, 4], "tripled": [0, 1, 2, 3, 4, 1, 1]}


def _tie_arrays(rows):
    """simple's fields (the JAX package's, float64) with its spheres taken
    in the order ``rows``."""
    js = pt.get_scene("simple", W, H, dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(js, f))[rows] for f in ("p0", "radius", "anchor_dir",
                                                             "emission", "albedo", "material")}
    arrays["background"] = np.asarray(js.background)
    arrays["camera"] = {f: np.asarray(getattr(js.camera, f)) for f in CAMERA_FIELDS}
    return arrays, js.ior


@pytest.mark.parametrize("name", list(TIE_SCENES))
def test_plain_replay_splits_exact_ties_as_scan_vjp(name):
    """Float64, 16x12, 2 spp, depth 8: where spheres' roots tie exactly, t's
    adjoint goes g_t / m to each through its own root, as the scan VJP's
    ``amin`` splits it: the plain geometry replay within 1e-9 relative (atol
    1e-9 of each field's largest magnitude) of the scan VJP, tied bounces
    counted, and the copies that never win a tie (the hit record stays the
    lowest index's) given gradients through their roots alone: equal where
    two of them copy one sphere."""
    arrays, ior = _tie_arrays(TIE_SCENES[name])
    scene = tp.scene_from_arrays(arrays, ior=ior)
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
    ct = torch.from_numpy(np.random.default_rng(8).normal(0, 1, (cfg.num_cells, 3)))
    got, st = _plain_grads(scene, cfg, ct)
    ref = _scan_grads(scene, cfg, ct)
    _assert_fields_close(got, ref, 1e-9, 1e-9)
    # Every hit ties when every sphere has a copy; with one sphere tripled,
    # only the hits on it.
    assert 0 < st["tied_bounces"] <= st["sweep_bounces"]
    assert (st["tied_bounces"] == st["sweep_bounces"]) == (name == "duplicated")
    assert float(got["radius"][6].abs()) > 0 and float(got["p0"][6].abs().max()) > 0
    if name == "tripled":
        assert torch.equal(got["radius"][5], got["radius"][6])
        assert torch.equal(got["p0"][5], got["p0"][6])


@pytest.mark.parametrize("name", list(TIE_SCENES))
def test_plain_replay_ties_match_jax_grad(name):
    """The tie scenes against ``jax.grad`` of the JAX package's ``cell_loss``
    (the scan loop on the CPU, as ``test_plain_replay_matches_jax_grad``):
    the plain geometry replay with the loss's cotangent within 1e-9 relative
    (atol 1e-9 of each field's largest magnitude)."""
    arrays, ior = _tie_arrays(TIE_SCENES[name])
    js = pt.get_scene("simple", W, H, dtype=jnp.float64)
    js = type(js)(**{f: jnp.asarray(arrays[f]) for f in ("p0", "radius", "anchor_dir",
                                                         "emission", "albedo", "material",
                                                         "background")},
                  camera=js.camera, ior=js.ior)
    jcfg = pt.RenderConfig(width=W, height=H, spp=SPP, max_depth=8, loop="scan")
    ids = jnp.arange(jcfg.num_cells, dtype=jnp.int32)
    target = jax_render_cells(js, jcfg, ids) * 0.9
    jg = jax.grad(jgrad.cell_loss)(jgrad.split_params(js, GEOMETRY_FIELDS), js, jcfg, ids, target)
    ref = {"p0": torch.from_numpy(np.array(jg["p0"])),
           "radius": torch.from_numpy(np.array(jg["radius"])),
           **{f"camera.{f}": torch.from_numpy(np.array(getattr(jg["camera"], f)))
              for f in CAMERA_FIELDS}}
    ts = tp.scene_from_arrays(arrays, ior=ior)
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
    cells = render_cells_range(ts, cfg, torch.arange(cfg.num_cells), 0, SPP) / SPP
    ct = 2.0 * (cells - torch.from_numpy(np.array(target))) / (SPP * cells.numel())
    got, st = _plain_grads(ts, cfg, ct)
    assert st["tied_bounces"] > 0
    _assert_fields_close(got, ref, 1e-9, 1e-9)


def _untie(monkeypatch):
    """Make ``bounce_forward`` report every hit sphere's root untied, so that
    it takes all of t's adjoint."""
    forward = gr.bounce_forward

    def untied(spheres, o, d, hid, u, **k):
        f = forward(spheres, o, d, hid, u, **k)
        f.tied = torch.nn.functional.one_hot(hid, f.tied.shape[1]).bool()
        f.ties = torch.ones_like(f.ties)
        return f

    monkeypatch.setattr(gr, "bounce_forward", untied)


@pytest.mark.parametrize("name,depth", [("simple", 8), ("simple", 100), ("box_mirror", 100),
                                        ("smallpt", 8), ("depth_of_field", 8)])
def test_plain_replay_without_ties_is_unchanged(name, depth, monkeypatch):
    """On scenes with no exact tie the split changes nothing: no tied
    bounce, and the partials bitwise equal to a replay whose hit sphere takes
    all of t's adjoint (every tie count forced to 1, which is what the
    replay computed before the split)."""
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=depth)
    scene = tp.get_scene(name, W, H, dtype=torch.float64)
    ct = torch.from_numpy(np.random.default_rng(depth).normal(0, 1, (cfg.num_cells, 3)))
    args = (mk.pack_scene(scene, torch.float64), mk.pack_camera(scene, torch.float64), (0, 0), ct)
    kw = dict(cfg=cfg, n_cells=cfg.num_cells, n_items=SPP * cfg.num_cells, ior=scene.ior)
    part, st = gk.geometry_replay(*args, **kw)
    assert st["tied_bounces"] == 0
    _untie(monkeypatch)
    alone, _ = gk.geometry_replay(*args, **kw)
    assert torch.equal(part, alone)


def test_plain_replay_untied_differs_on_a_tie_scene(monkeypatch):
    """The forced tie count of ``test_plain_replay_without_ties_is_unchanged``
    is no identity: on the duplicated scene it moves the radius gradients
    (the hit sphere then takes t's whole adjoint)."""
    arrays, ior = _tie_arrays(TIE_SCENES["duplicated"])
    scene = tp.scene_from_arrays(arrays, ior=ior)
    cfg = tp.RenderConfig(width=W, height=H, spp=SPP, max_depth=8)
    ct = torch.from_numpy(np.random.default_rng(8).normal(0, 1, (cfg.num_cells, 3)))
    split, _ = _plain_grads(scene, cfg, ct)
    _untie(monkeypatch)
    alone, _ = _plain_grads(scene, cfg, ct)
    assert float(alone["radius"][6].abs()) == 0.0 < float(split["radius"][6].abs())


def test_geometry_record_bytes_is_one_sector_a_bounce():
    """The record's traffic: one 32-byte sector (8 float32 words: origin,
    direction, hit id, tie count) stored a segment, 16 bytes for a path's
    last, and loaded a bounce swept back; the kernel's record holds
    ``RECORD_WORDS`` = 8 words a bounce.  A tied bounce is charged one more
    sphere's root and root VJP whatever the scene's sphere count."""
    from cpu_path_tracing_tpu_torch.utils import roofline

    assert gk.RECORD_WORDS * 4 == 32
    assert roofline.geometry_record_bytes(0, 0, 0) == 0
    assert roofline.geometry_record_bytes(1, 0, 1) == 16
    assert roofline.geometry_record_bytes(5_035_384, 0, 2_097_152) == (
        32 * 5_035_384 - 16 * 2_097_152)
    assert roofline.geometry_record_bytes(4_735_949, 2_615_881, 2_097_152) == (
        32 * (4_735_949 + 2_615_881) - 16 * 2_097_152)
    for n in (5, 10, 40):
        ops = roofline.geometry_ops(n, 100, 10, 20, 5, tied_bounces=3)
        base = roofline.geometry_ops(n, 100, 10, 20, 5)
        assert ops.issues() - base.issues() == 3 * roofline.geometry_tie_ops().issues() > 0
